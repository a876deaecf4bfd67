"""Single-step and multi-step model wrappers.

Counterpart of makani_tpu/models/stepper.py: preprocess -> model ->
denormalize, with the configurable land-sea-mask gate (`lsm_mask_channels`).
The multi-step training unroll of MultiStepWrapper (n_future > 0) is not
ported yet; its eval path (one step) is.
"""

from torch import nn


class SingleStepWrapper(nn.Module):
    """preprocess -> model -> denormalize."""

    def __init__(self, preprocessor, model, lsm_mask_channels=()):
        super().__init__()
        self.preprocessor = preprocessor
        self.model = model
        self.lsm_mask_channels = tuple(lsm_mask_channels)

    def _lsm_gate(self, x, lsm):
        """Multiply the configured channels by the land plane (the last input
        channel after static features)."""
        out = x.clone()
        for c in self.lsm_mask_channels:
            out[:, c] = out[:, c] * lsm
        return out

    def _single(self, inp, unpredicted_inp, deterministic):
        prep = self.preprocessor
        inpa = inp if unpredicted_inp is None else prep.append_channels(inp, unpredicted_inp)
        stats = prep.history_compute_stats(inpa)
        inpan = prep.history_normalize(inpa, stats, target=False)
        inpans = prep.add_static_features(inpan)
        if self.lsm_mask_channels:
            lsm = inpans[:, -1]
            inpans = self._lsm_gate(inpans, lsm)
        yn = self.model(inpans, deterministic=deterministic)
        y = prep.history_denormalize(yn, stats, target=True)
        if self.lsm_mask_channels:
            y = self._lsm_gate(y, lsm)
        return prep.add_residual(inp, y)

    def forward(self, inp, unpredicted_inp=None, unpredicted_tar=None, deterministic=True):
        return self._single(inp, unpredicted_inp, deterministic)


class MultiStepWrapper(SingleStepWrapper):
    """One step in eval mode whatever n_future; the training unroll is not
    ported yet."""

    def __init__(self, preprocessor, model, n_future=0, lsm_mask_channels=()):
        super().__init__(preprocessor, model, lsm_mask_channels)
        self.n_future = n_future

    def forward(self, inp, unpredicted_inp=None, unpredicted_tar=None, deterministic=True):
        if not deterministic:
            raise NotImplementedError("the multi-step training unroll is not ported yet "
                                      "(ROADMAP: Queue 1)")
        return self._single(inp, unpredicted_inp, deterministic)
