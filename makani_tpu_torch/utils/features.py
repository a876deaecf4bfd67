"""Names of the auxiliary input channels, in the order the preprocessor and
the datasets append them.

Copy of makani_tpu/utils/features.py (the port imports nothing of
makani_tpu).
"""


def get_auxiliary_channels(
    add_zenith=False,
    add_grid=False,
    grid_type=None,
    grid_num_frequencies=0,
    add_orography=False,
    add_landmask=False,
    **kwargs,
):
    channel_names = []

    if add_zenith:
        channel_names.append("xzen")

    if add_grid:
        if grid_type == "sinusoidal":
            for f in range(1, grid_num_frequencies + 1):
                channel_names += [f"xsgrlat{f}", f"xsgrlon{f}"]
        else:
            channel_names += ["xgrlat", "xgrlon"]

    if add_orography:
        channel_names.append("xoro")

    if add_landmask:
        channel_names += ["xlsml", "xlsms"]

    return channel_names
