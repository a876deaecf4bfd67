"""Single-step and multi-step model wrappers.

Counterpart of makani_tpu/models/stepper.py: preprocess -> model ->
denormalize, with the configurable land-sea-mask gate (`lsm_mask_channels`).
MultiStepWrapper unrolls n_future + 1 steps in training and takes one in
eval. A network that is not spatially parallel (a class registered from a
file) is called through spmd.whole_field, on the whole field of its input
(global (H, W) `global_hw`) on every layout; no module wraps it, so the
state dict's keys are the same serially and on ranks.
"""

import torch
from torch import nn

from makani_tpu_torch.models.common.layers import current_dropout_key, use_dropout_key
from makani_tpu_torch.parallel import spmd


class SingleStepWrapper(nn.Module):
    """preprocess -> model -> denormalize."""

    def __init__(self, preprocessor, model, lsm_mask_channels=(), global_hw=None):
        super().__init__()
        self.preprocessor = preprocessor
        self.model = model
        self.lsm_mask_channels = tuple(lsm_mask_channels)
        self.global_hw = None if global_hw is None else tuple(global_hw)

    def _network(self, x, deterministic):
        if spmd.spatially_parallel(self.model):
            return self.model(x, deterministic=deterministic)
        return spmd.whole_field(self.model, x, self.global_hw, deterministic=deterministic)

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
        yn = self._network(inpans, deterministic)
        y = prep.history_denormalize(yn, stats, target=True)
        if self.lsm_mask_channels:
            y = self._lsm_gate(y, lsm)
        return prep.add_residual(inp, y)

    def forward(self, inp, unpredicted_inp=None, unpredicted_tar=None, deterministic=True):
        return self._single(inp, unpredicted_inp, deterministic)


class MultiStepWrapper(SingleStepWrapper):
    """One step in eval mode whatever n_future. In training, n_future + 1
    single steps, each prediction appended to the next step's history and the
    zenith window advanced to the next target's, the land-sea-mask gate at
    every step; the predictions concatenated along channels to match the
    flattened target. Each unrolled step draws its dropout masks under its own
    substep of the dropout key."""

    def __init__(self, preprocessor, model, n_future=0, lsm_mask_channels=(), global_hw=None):
        super().__init__(preprocessor, model, lsm_mask_channels, global_hw)
        self.n_future = n_future

    def forward(self, inp, unpredicted_inp=None, unpredicted_tar=None, deterministic=True):
        if deterministic:
            return self._single(inp, unpredicted_inp, deterministic)
        prep = self.preprocessor
        key = current_dropout_key()
        result = []
        inpt, uinp = inp, unpredicted_inp
        for step in range(self.n_future + 1):
            with use_dropout_key(None if key is None else key._replace(substep=step)):
                pred = self._single(inpt, uinp, deterministic)
            result.append(pred)
            if step == self.n_future:
                break
            uinp = prep.advance_unpredicted(uinp, unpredicted_tar, step)
            inpt = prep.append_history(inpt, pred)
        return torch.cat(result, dim=1)
