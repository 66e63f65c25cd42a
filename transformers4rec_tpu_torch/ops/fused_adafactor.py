"""Adafactor for embedding tables, unfactored second moment.

Counterpart of ``transformers4rec_tpu/ops/fused_adafactor.py:fused_adafactor``
on its default path: the unfactored branch, written in plain tensor code (the
JAX default is a plain ``jnp`` chain too; its opt-in Pallas passes, kernel K7,
are not ported yet and ``use_pallas=True`` raises). For step t counted from 0:

    decay = 1 − (t + 1)^−0.8
    v     = cast(decay·v + (1 − decay)·(g² + eps), moment_dtype)
    inv   = rsqrt(float32(v))                 # of the *stored*, rounded value
    rms   = sqrt(mean((g·inv)²));  scale = 1 / max(1, rms / clipping_threshold)
    p    += g · (−lr·scale·inv)

No weight decay, no parameter scale. ``moment_dtype=torch.bfloat16`` halves
the optimizer's state; the arithmetic stays float32. Parameters are updated
in place; nothing is read back to the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

NEVER_FACTOR = 1 << 30


class FusedAdafactor(torch.optim.Optimizer):
    """``lr`` is a float or a callable of the step (counted from 0)."""

    def __init__(
        self,
        params,
        lr: Union[float, Callable[[int], float]],
        min_dim_size_to_factor: int = NEVER_FACTOR,
        decay_rate: float = 0.8,
        clipping_threshold: Optional[float] = 1.0,
        eps: float = 1e-30,
        use_pallas: bool = False,
        moment_dtype: Optional[torch.dtype] = None,
    ):
        if use_pallas:
            raise NotImplementedError(
                "the streamed two-pass table update (kernel K7) is not ported yet"
            )
        if min_dim_size_to_factor < NEVER_FACTOR:
            raise NotImplementedError("factored second moments are not ported yet")
        self.learning_rate = lr
        # the schedule itself stays out of the param groups: state_dict() holds
        # only what torch.save can write. group["lr"] is the last rate applied.
        defaults = dict(lr=float(lr(0)) if callable(lr) else float(lr), decay_rate=decay_rate,
                        clipping_threshold=clipping_threshold, eps=eps,
                        moment_dtype=moment_dtype)
        super().__init__(params, defaults)

    def _lr_at(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    def load_state_dict(self, state_dict) -> None:
        # the base class casts every state tensor to its parameter's dtype;
        # the moment goes back to its storage dtype (bf16 -> f32 -> bf16 is exact)
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                if "v" in self.state.get(p, {}):
                    self.state[p]["v"] = self.state[p]["v"].to(group["moment_dtype"] or p.dtype)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            clip, eps = group["clipping_threshold"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["v"] = torch.zeros_like(p, dtype=group["moment_dtype"] or p.dtype)
                step = state["step"]
                group["lr"] = lr = self._lr_at(step)
                g = p.grad.float()
                # float32 scalars on the device, as the reference computes them
                decay = 1.0 - torch.full((), float(step + 1), dtype=torch.float32,
                                         device=p.device) ** -group["decay_rate"]
                new_v = (decay * state["v"].float() + (1.0 - decay) * (g * g + eps))
                state["v"] = new_v.to(state["v"].dtype)
                inv = torch.rsqrt(state["v"].float())
                if clip is not None:
                    rms = torch.sqrt(torch.mean((g * inv) ** 2))
                    scale = 1.0 / torch.clamp_min(rms / clip, 1.0)
                else:
                    scale = 1.0
                p.add_((g * ((-lr * scale) * inv)).to(p.dtype))
                state["step"] = step + 1
        return loss
