"""Solar zenith angle from orbital mechanics (host-side float64 numpy).

Copy of makani_tpu/utils/zenith_angle.py (the port imports nothing of
makani_tpu): the climt algorithm from its published formulas (AIAA 2006
GMST, Meeus solar position), vectorized over time. Time is expressed as float
days since 2000-01-01 12:00 UTC, the convention of utils/timetools.py. The
datasets compute cos(zenith) channels for the input and target timestamps
with it; the arithmetic is makani_tpu's, operation for operation, so the
channels are the same bits.
"""

import datetime

import numpy as np

_EPOCH = datetime.datetime(2000, 1, 1, 12, 0, tzinfo=datetime.timezone.utc)


def days_since_2000(model_time):
    """datetime (aware or naive-UTC) -> float days since 2000-01-01 12:00 UTC."""
    times = np.atleast_1d(np.asarray(model_time))
    out = np.empty(times.shape, dtype=np.float64)
    for i, t in np.ndenumerate(times):
        t = t.item() if hasattr(t, "item") else t
        if isinstance(t, (float, int)):
            out[i] = float(t)
        else:
            if t.tzinfo is None:
                t = t.replace(tzinfo=datetime.timezone.utc)
            out[i] = (t - _EPOCH).total_seconds() / 86400.0
    return out


def _greenwich_mean_sidereal_time(d2000):
    jul_centuries = d2000 / 36525.0
    theta = 67310.54841 + jul_centuries * (
        876600 * 3600 + 8640184.812866 + jul_centuries * (0.093104 - jul_centuries * 6.2e-5)
    )
    return np.deg2rad(theta / 240.0) % (2 * np.pi)


def _sun_ecliptic_longitude(d2000):
    T = d2000 / 36525.0
    mean_anomaly = np.deg2rad(357.52910 + 35999.05030 * T - 0.0001559 * T**2 - 0.00000048 * T**3)
    mean_longitude = np.deg2rad(280.46645 + 36000.76983 * T + 0.0003032 * T**2)
    d_l = np.deg2rad(
        (1.914600 - 0.004817 * T - 0.000014 * T**2) * np.sin(mean_anomaly)
        + (0.019993 - 0.000101 * T) * np.sin(2 * mean_anomaly)
        + 0.000290 * np.sin(3 * mean_anomaly)
    )
    return mean_longitude + d_l


def _obliquity(T):
    return np.deg2rad(
        23.0 + 26.0 / 60 + 21.406 / 3600.0
        - (46.836769 * T - 0.0001831 * T**2 + 0.00200340 * T**3
           - 0.576e-6 * T**4 - 4.34e-8 * T**5) / 3600.0
    )


def _right_ascension_declination(d2000):
    T = d2000 / 36525.0
    eps = _obliquity(T)
    eclon = _sun_ecliptic_longitude(d2000)
    x = np.cos(eclon)
    y = np.cos(eps) * np.sin(eclon)
    z = np.sin(eps) * np.sin(eclon)
    r = np.sqrt(1.0 - z * z)
    declination = np.arctan2(z, r)
    right_ascension = 2.0 * np.arctan2(y, (x + r))
    return right_ascension, declination


def cos_zenith_angle(time, lon, lat):
    """Cosine of the solar zenith angle.

    Parameters
    ----------
    time : datetimes or float days-since-2000-01-01T12Z, shape (T,) or scalar
    lon, lat : degrees, arrays broadcastable to a (lat, lon) grid

    Returns
    -------
    (T, *grid) float32 array of cos(zenith)
    """
    d2000 = days_since_2000(time)  # (T,)
    lon_rad = np.deg2rad(np.asarray(lon, dtype=np.float64))
    lat_rad = np.deg2rad(np.asarray(lat, dtype=np.float64))

    ra, dec = _right_ascension_declination(d2000)
    shape_extra = (1,) * lon_rad.ndim
    gmst = _greenwich_mean_sidereal_time(d2000).reshape(-1, *shape_extra)
    ra = ra.reshape(-1, *shape_extra)
    dec = dec.reshape(-1, *shape_extra)

    h_angle = gmst + lon_rad[None] - ra
    cosine_zenith = np.sin(lat_rad)[None] * np.sin(dec) + np.cos(lat_rad)[None] * np.cos(dec) * np.cos(h_angle)
    return cosine_zenith.astype(np.float32)


def cos_zenith_angle_grid(time, lon_deg, lat_deg):
    """cos(zenith) on a separable lat/lon grid: returns (T, nlat, nlon)."""
    lon2d, lat2d = np.meshgrid(np.asarray(lon_deg), np.asarray(lat_deg))
    return cos_zenith_angle(time, lon2d, lat2d)
