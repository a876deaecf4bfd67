"""Date arithmetic on float days-since-2000-01-01T12Z.

Copy of makani_tpu/utils/timetools.py (the port imports nothing of
makani_tpu), on the standard library's datetime.
"""

import datetime

_EPOCH = datetime.datetime(2000, 1, 1, 12, 0, tzinfo=datetime.timezone.utc)


def datetime_to_days2000(dt):
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return (dt - _EPOCH).total_seconds() / 86400.0


def days2000_to_datetime(days):
    return _EPOCH + datetime.timedelta(days=float(days))


def year_start_days2000(year):
    return datetime_to_days2000(datetime.datetime(year, 1, 1, tzinfo=datetime.timezone.utc))


def hours_range(start_dt, n_steps, dhours):
    return [start_dt + datetime.timedelta(hours=i * dhours) for i in range(n_steps)]
