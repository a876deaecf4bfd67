"""Dataset metadata (data.json) parsing.

Copy of makani_tpu/utils/dataset_metadata.py (the port imports nothing of
makani_tpu): reads the dataset descriptor into params. ``channel_names`` in
the experiment config selects a *subset* of the dataset's channels; the
resulting index lists become ``in_channels``/``out_channels``.
"""

import json


def parse_dataset_metadata(metadata_json_path, params):
    with open(metadata_json_path, "r") as f:
        metadata = json.load(f)

    params["h5_path"] = metadata["h5_path"]
    params["dhours"] = metadata["dhours"]
    params["lat"] = metadata["coords"]["lat"]
    params["lon"] = metadata["coords"]["lon"]
    params["data_grid_type"] = metadata["coords"]["grid_type"]

    channel_names = metadata["coords"]["channel"]
    channels_idx = []
    if hasattr(params, "channel_names") and params["channel_names"] is not None:
        for pchn in params["channel_names"]:
            if pchn not in channel_names:
                raise ValueError(f"Error, requested channel {pchn} not found in dataset.")
            channels_idx.append(channel_names.index(pchn))
    else:
        params["channel_names"] = channel_names
        channels_idx = list(range(len(channel_names)))

    params["in_channels"] = channels_idx
    params["out_channels"] = channels_idx

    params["dataset"] = dict(
        name=metadata["dataset_name"],
        description=metadata.get("attrs", {}).get("description", ""),
        metadata_file=metadata_json_path,
    )

    return params, metadata
