"""Visualization: prediction/target comparison images, rollout metric plots
and rollout videos.

Counterpart of makani_tpu/utils/visualize.py, with its arithmetic as it is:
for the same arrays the files carry the same names, the AVI and GIF files
the same bytes and the PNG files the same pixels. Videos are MJPEG AVI (a
RIFF container written here around PIL's JPEG frames) or animated GIF.

matplotlib and PIL are imported inside the functions that draw or encode,
through utils/imports.import_optional: the module imports without them.

The rendering runs on the host in a process pool with a *spawn* context (a
forked pool under the Trainer's loader and checkpoint threads and an
initialized CUDA context can deadlock). Its workers import this module
alone, which imports neither torch nor CUDA: they are given host numpy
arrays.
"""

import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from makani_tpu_torch.utils.imports import import_optional

logger = logging.getLogger(__name__)

_HINT = "rendering images and videos needs matplotlib and PIL (Pillow) on the host"


def _matplotlib(what):
    matplotlib = import_optional("matplotlib", what, hint=_HINT)
    matplotlib.use("Agg")
    return matplotlib


def _pyplot(what):
    _matplotlib(what)
    return import_optional("matplotlib.pyplot", what, hint=_HINT)


def _render_comparison(args):
    """A (prediction | target) panel pair per channel; returns the path."""
    tag, pred, targ, out_path, projection = args
    plt = _pyplot("the comparison image")
    nchan = pred.shape[0]
    fig, axes = plt.subplots(nchan, 2, figsize=(10, 3 * nchan),
                             subplot_kw={"projection": projection} if projection else None,
                             squeeze=False)
    for c in range(nchan):
        for col, (name, field) in enumerate([("prediction", pred[c]), ("target", targ[c])]):
            ax = axes[c][col]
            if projection:
                nlat, nlon = field.shape
                lons = np.linspace(-np.pi, np.pi, nlon)
                lats = np.linspace(np.pi / 2, -np.pi / 2, nlat)
                Lon, Lat = np.meshgrid(lons, lats)
                im = ax.pcolormesh(Lon, Lat, field, cmap="twilight_shifted", rasterized=True)
                ax.set_axis_off()
            else:
                im = ax.imshow(field, cmap="twilight_shifted")
            ax.set_title(f"{name} c{c}")
            fig.colorbar(im, ax=ax, shrink=0.7)
    fig.suptitle(tag)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


class VisualizationWrapper:
    """Renders comparisons and rollout videos into
    <experiment_dir>/<path_suffix>/ in a spawned process pool; `finalize`
    waits for them and returns their paths, `close` stops the workers."""

    def __init__(self, params, path_suffix="visualizations", num_workers=1,
                 projection="mollweide"):
        self.out_dir = os.path.join(params.experiment_dir, path_suffix)
        os.makedirs(self.out_dir, exist_ok=True)
        self.projection = projection
        self.executor = ProcessPoolExecutor(max_workers=num_workers,
                                            mp_context=multiprocessing.get_context("spawn"))
        self.futures = []

    def add(self, tag, pred, targ):
        """<tag>.png: pred and targ, host arrays [C, H, W]."""
        out_path = os.path.join(self.out_dir, f"{tag}.png")
        self.futures.append(self.executor.submit(
            _render_comparison, (tag, np.asarray(pred), np.asarray(targ), out_path,
                                 self.projection)))

    def add_video(self, tag, pred_frames, targ_frames, fps=4, fmt="avi"):
        """<tag>.<fmt>: a side-by-side animation of [T, H, W] host frames of
        one channel."""
        out_path = os.path.join(self.out_dir, f"{tag}.{fmt}")
        self.futures.append(self.executor.submit(
            render_rollout_video, np.asarray(pred_frames), np.asarray(targ_frames),
            out_path, fps))

    def finalize(self):
        paths = [f.result() for f in self.futures]
        self.futures = []
        return paths

    def close(self):
        self.executor.shutdown()


def _colorize(field, vmin, vmax, cmap="twilight_shifted"):
    """Map a 2D field to uint8 RGB through a matplotlib colormap."""
    matplotlib = _matplotlib("colouring video frames")
    norm = np.clip((field - vmin) / max(vmax - vmin, 1e-12), 0.0, 1.0)
    rgba = matplotlib.colormaps[cmap](norm)
    return (rgba[..., :3] * 255).astype(np.uint8)


def write_mjpeg_avi(frames, out_path, fps=4, quality=90):
    """Write uint8 RGB frames [T, H, W, 3] as an MJPEG AVI: a RIFF container
    written here around PIL's JPEG frames."""
    import io
    import struct
    Image = import_optional("PIL.Image", "writing an MJPEG AVI", hint=_HINT)

    frames = np.asarray(frames)
    T, H, W = frames.shape[:3]

    encoded = []
    for t in range(T):
        buf = io.BytesIO()
        Image.fromarray(frames[t]).save(buf, format="JPEG", quality=quality)
        # the payload unpadded: a RIFF chunk's size excludes the pad byte that
        # chunk() appends to an odd-length payload
        encoded.append(buf.getvalue())
    max_size = max(len(d) for d in encoded)

    def chunk(fourcc, payload):
        return fourcc + struct.pack("<I", len(payload)) + payload + (
            b"\x00" if len(payload) % 2 else b"")

    def lst(fourcc, payload):
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack("<14I", int(1e6 / fps), max_size * fps, 0, 0x10, T, 0, 1, max_size, W, H,
                       0, 0, 0, 0)
    strh = b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIII4H", 0, 0, 0, 0, 1, fps, 0, T, max_size, 0xFFFFFFFF, 0, 0, 0, W, H)
    strf = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"MJPG", W * H * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh)
                                                   + chunk(b"strf", strf)))

    movi = lst(b"movi", b"".join(chunk(b"00dc", d) for d in encoded))

    idx, offset = b"", 4
    for d in encoded:
        size = len(d)
        idx += b"00dc" + struct.pack("<III", 0x10, offset, size)
        offset += 8 + size + (size % 2)
    idx1 = chunk(b"idx1", idx)

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(out_path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
    return out_path


def write_gif(frames, out_path, fps=4):
    """An animated GIF of uint8 RGB frames [T, H, W, 3]."""
    Image = import_optional("PIL.Image", "writing a GIF", hint=_HINT)
    imgs = [Image.fromarray(f) for f in np.asarray(frames)]
    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return out_path


def render_rollout_video(pred, targ, out_path, fps=4, cmap="twilight_shifted"):
    """A side-by-side prediction | target animation of one channel, pred and
    targ [T, H, W], on one colour scale; the container follows the file's
    extension (.gif a GIF, else an MJPEG AVI)."""
    pred, targ = np.asarray(pred), np.asarray(targ)
    vmin = float(min(pred.min(), targ.min()))
    vmax = float(max(pred.max(), targ.max()))
    frames = []
    for t in range(pred.shape[0]):
        left = _colorize(pred[t], vmin, vmax, cmap)
        right = _colorize(targ[t], vmin, vmax, cmap)
        sep = np.zeros((left.shape[0], 4, 3), np.uint8)
        frames.append(np.concatenate([left, sep, right], axis=1))
    if out_path.endswith(".gif"):
        return write_gif(frames, out_path, fps=fps)
    return write_mjpeg_avi(frames, out_path, fps=fps)


def plot_rollout_metrics(acc_curves, rmse_curves, params, epoch=0, model_name="model"):
    """The ACC and RMSE curves of each channel over lead time, one PNG a
    channel under <experiment_dir>/rollout_plots/; returns the paths."""
    plt = _pyplot("the rollout plots")
    out_dir = os.path.join(params.experiment_dir, "rollout_plots")
    os.makedirs(out_dir, exist_ok=True)

    acc = np.asarray(acc_curves)
    rmse = np.asarray(rmse_curves)
    dtxdh = params.dt * params.dhours
    hours = dtxdh * (1 + np.arange(acc.shape[1]))
    channel_names = list(params.channel_names)

    paths = []
    for c in range(acc.shape[0]):
        name = channel_names[c] if c < len(channel_names) else f"ch{c}"
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        ax1.plot(hours, acc[c], marker="o")
        ax1.set_xlabel("lead time [h]")
        ax1.set_ylabel("ACC")
        ax1.set_ylim(0, 1.05)
        ax1.grid(True, alpha=0.3)
        ax2.plot(hours, rmse[c], marker="o", color="tab:red")
        ax2.set_xlabel("lead time [h]")
        ax2.set_ylabel("RMSE")
        ax2.grid(True, alpha=0.3)
        fig.suptitle(f"{model_name} rollout: {name} (epoch {epoch})")
        fig.tight_layout()
        path = os.path.join(out_dir, f"rollout_{name}_epoch{epoch}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        paths.append(path)
    return paths
