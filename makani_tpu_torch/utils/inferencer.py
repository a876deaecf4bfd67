"""Inference engine: the autoregressive rollout core.

Counterpart of the rollout core of makani_tpu/utils/inferencer.py
(_build_inference_steps :107-166, _rollout_capture / _rollout_lite
:183-201): an Inferencer built from params and weights runs a host loop over
one AR step. `lite_step` predicts without targets, optionally pinning the
`sst_persistence_channels` to their initial-condition value; `capture_step`
also slices the matching target frame.

Not ported yet (ROADMAP, Queue 1): the dataset-backed inference_single,
inference_lite and inference_epoch, MetricsHandler, checkpoints, AMP
(bf16 inputs) and the inference.py CLI.
"""

import torch

from makani_tpu_torch.models.model_registry import as_params, get_model
from makani_tpu_torch.utils.device import resolve_device


class Inferencer:
    """Rollouts of the configured model on `device` (default "cuda").

    `weights` is a state dict of the stepper (e.g. from
    tools/convert_jax_params.py); without it the weights are drawn from a
    generator seeded with the config's global_seed.
    """

    def __init__(self, params, weights=None, device=None):
        self.device = resolve_device(device)
        params = as_params(params)
        if params.get("amp_mode", "none") not in ("none", None):
            raise NotImplementedError("AMP inference is not ported yet (ROADMAP: Queue 1)")
        self.params = params
        self.model = get_model(params, device=self.device)
        if weights is not None:
            self.model.load_state_dict(weights)
        self.model.eval()
        self.preprocessor = self.model.preprocessor
        self._S = params.valid_autoreg_steps + 1
        self.sst_persistence_channels = tuple(params.get("sst_persistence_channels", ()) or ())

    def _fwd(self, inpt, uinp):
        return self.model(inpt, unpredicted_inp=uinp, deterministic=True).float()

    @torch.inference_mode()
    def capture_step(self, inpt, uinp, tar, zen_tar, idt):
        prep = self.preprocessor
        t = min(idt, tar.shape[1] - 1)
        targ = prep.flatten_history(tar[:, t: t + 1])
        pred = self._fwd(inpt, uinp)
        uinp = prep.advance_unpredicted_dyn(uinp, zen_tar, idt)
        return pred, targ, prep.append_history(inpt, pred), uinp

    @torch.inference_mode()
    def lite_step(self, inpt, uinp, zen_tar, idt):
        prep = self.preprocessor
        pred = self._fwd(inpt, uinp)
        if self.sst_persistence_channels:
            # pinning each step keeps the channel at its IC value inductively
            pred = pred.clone()
            for c in self.sst_persistence_channels:
                pred[:, c] = inpt[:, c]
        uinp = prep.advance_unpredicted_dyn(uinp, zen_tar, idt)
        return pred, prep.append_history(inpt, pred), uinp

    def _put(self, x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def _host_buffer(self, steps, like):
        """(steps, *like.shape) float32 host array the predictions are copied
        into as they come: page-locked when they come from the GPU, so each
        step's copy runs at the link's rate and no stacking copy follows."""
        return torch.empty((steps, *like.shape), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def _finish(self, *buffers):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return tuple(b.numpy() for b in buffers)

    def _rollout_capture(self, inp, tar, zen_inp=None, zen_tar=None):
        """(steps, B, C, H, W) predictions and targets as numpy arrays."""
        inpt = self.preprocessor.flatten_history(self._put(inp))
        tar, uinp, zen_tar = self._put(tar), self._put(zen_inp), self._put(zen_tar)
        preds = targs = None
        for idt in range(self._S):
            pred, targ, inpt, uinp = self.capture_step(inpt, uinp, tar, zen_tar, idt)
            if preds is None:
                preds, targs = self._host_buffer(self._S, pred), self._host_buffer(self._S, targ)
            preds[idt].copy_(pred, non_blocking=True)
            targs[idt].copy_(targ, non_blocking=True)
        return self._finish(preds, targs)

    def _rollout_lite(self, inp, zen_inp=None, zen_tar=None):
        """(steps, B, C, H, W) predictions as a numpy array."""
        inpt = self.preprocessor.flatten_history(self._put(inp))
        uinp, zen_tar = self._put(zen_inp), self._put(zen_tar)
        preds = None
        for idt in range(self._S):
            pred, inpt, uinp = self.lite_step(inpt, uinp, zen_tar, idt)
            if preds is None:
                preds = self._host_buffer(self._S, pred)
            preds[idt].copy_(pred, non_blocking=True)
        return self._finish(preds)[0]
