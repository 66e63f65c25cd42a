"""Adafactor for embedding tables.

Counterpart of ``transformers4rec_tpu/ops/fused_adafactor.py:fused_adafactor``.
For step t counted from 0, ``decay = 1 − (t + 1)^−decay_rate``. No weight
decay, no parameter scale. Parameters and moments are updated in place;
nothing is read back to the host.

**Unfactored second moment** (the default, ``min_dim_size_to_factor`` never
reached), in plain tensor code:

    v     = cast(decay·v + (1 − decay)·(g² + eps), moment_dtype)
    inv   = rsqrt(float32(v))                 # of the *stored*, rounded value
    rms   = sqrt(mean((g·inv)²));  scale = 1 / max(1, rms / clipping_threshold)
    p    += g · (−lr·scale·inv)

``moment_dtype=torch.bfloat16`` halves the optimizer's state; the arithmetic
stays float32.

**The streamed table update** (``use_pallas=True``, named after the
reference's option): a 2-D parameter with at least ``4 * 512`` rows takes
the same update in two passes over the table, ``adafactor_update`` (kernels
K7a and K7b, ``csrc/adafactor.cu``): pass A writes the new moment over the
old one and sums ``(g·rsqrt(v))²``; pass B adds ``g·coef·rsqrt(v)`` to the
parameter. The moment is stored in the parameter's type (``use_pallas``
with a ``moment_dtype`` raises, as in the reference). For an f32 table pass
B reads the moment unrounded. For a bf16-stored table g, v and p are all
bf16: pass A sums the clip's terms from the unrounded f32 moment and stores
it rounded, pass B reads the rounded moment, rounds the update to bf16 and
adds it with one more rounding, as the reference's update cast to
``p.dtype`` and optax's ``apply_updates`` give. Smaller and 1-D parameters
take the plain chain. For CUDA tensors
``adafactor_update`` launches the kernels (and raises when it cannot); for
CPU tensors it runs their plain versions (``adafactor_update_plain`` is the
two together). The launches are counted in
``adafactor_pass_a.launches`` and ``adafactor_pass_b.launches``.

**Factored second moment** (``min_dim_size_to_factor`` at or below the
second-largest axis of a parameter), in plain tensor code: row and column
means of g² feed two vectors, and the update is ``g·(−lr·scale)·rf·cf`` with
the clip's rms taken from ``g²·rf²·cf²``.

**A row shard** (``row_shards``: parameter → process group, set by the
trainer for a table row-sharded over a model group): the moment lives on the
shard's rows, and every sum that the update on the whole table takes over
its rows is summed over the group: the clip's numerator (its mean over the
whole table's elements) and, factored, the mean over the rows. The streamed
update's pass A leaves its per-block sums in its scratch, and the step's
coefficient is taken again from their sum over the group.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from .build import raise_on_error

NEVER_FACTOR = 1 << 30
STREAMED_MIN_ROWS = 4 * 512  # the reference's 4 blocks of 512 rows
_BLOCKS_PER_SM = 8


def _coef(total: torch.Tensor, numel: int, lr: float,
          clipping_threshold: Optional[float]) -> torch.Tensor:
    """``-lr / max(1, sqrt(total / numel) / clip)`` as a (1,) f32 tensor."""
    scale = torch.ones(1, dtype=torch.float32, device=total.device)
    if clipping_threshold is not None:
        rms = torch.sqrt(total / numel)
        scale = scale / torch.clamp_min(rms / clipping_threshold, 1.0)
    return (-lr * scale).to(torch.float32)


def adafactor_pass_a_plain(
    g: torch.Tensor,
    v: torch.Tensor,
    decay: torch.Tensor,
    lr: float,
    clipping_threshold: Optional[float],
    eps: float,
    group=None,
    numel: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch K7a: the new moment over ``v`` in place (rounded to
    ``v``'s type), and the step's coefficient ``-lr / max(1, rms / clip)`` as
    a (1,) f32 tensor (``-lr`` without a clip); ``rms`` is the root of the
    mean of ``(g·rsqrt(nv))²`` over the unrounded f32 moment ``nv``. For a
    row shard the sum goes over ``group`` and the mean over ``numel``, the
    whole table's elements."""
    g = g.float()
    nv = decay * v.float() + (1.0 - decay) * (g * g + eps)
    v.copy_(nv)
    total = ((g * torch.rsqrt(nv)) ** 2).sum() if clipping_threshold is not None \
        else torch.zeros((), device=v.device)
    if group is not None and clipping_threshold is not None:
        dist.all_reduce(total, group=group)
    return _coef(total, numel or v.numel(), lr, clipping_threshold)


def adafactor_pass_b_plain(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                           coef: torch.Tensor) -> None:
    """Plain PyTorch K7b: ``p += g·coef·rsqrt(v)`` in place, the update
    rounded to ``p``'s type before the sum (a no-op for f32)."""
    upd = g.float() * (coef * torch.rsqrt(v.float()))
    p.copy_(p.float() + upd.to(p.dtype).float())


def adafactor_update_plain(
    p: torch.Tensor,
    g: torch.Tensor,
    v: torch.Tensor,
    decay: torch.Tensor,
    lr: float,
    clipping_threshold: Optional[float],
    eps: float,
) -> None:
    """The two passes in plain PyTorch, in place on ``v`` and ``p`` (all f32,
    or all bf16; ``decay`` an f32 scalar tensor)."""
    adafactor_pass_b_plain(p, g, v, adafactor_pass_a_plain(g, v, decay, lr,
                                                           clipping_threshold, eps))


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _adafactor_lib() -> ctypes.CDLL:
    """The library of ``csrc/adafactor.cu`` with its C functions typed."""
    from .build import load

    lib = load("adafactor")
    if not getattr(lib, "_t4r_typed", False):
        for suffix in ("", "_bf16"):
            a = getattr(lib, "t4r_adafactor_a" + suffix)
            b = getattr(lib, "t4r_adafactor_b" + suffix)
            a.argtypes = [_P, _P, _P, _F, _L, _I, _F, _F, _I, _P, _P, _P]
            b.argtypes = [_P, _P, _P, _L, _I, _P, _P]
            a.restype = b.restype = _I
        lib.t4r_adafactor_threads.argtypes, lib.t4r_adafactor_threads.restype = [], _I
        lib._t4r_typed = True
    return lib


def _check_cuda_tensors(op: str, like: torch.Tensor, scalars: Tuple[str, ...], **tensors) -> None:
    """Raise on what the kernels do not take: contiguous, 16-byte aligned and
    on one CUDA device; ``scalars`` hold one f32 value, the others have the
    shape of ``like`` and its type, f32 or bf16."""
    if like.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{op}: {like.dtype} tensors, expected torch.float32 or torch.bfloat16")
    for name, t in tensors.items():
        if t.device != like.device or t.device.type != "cuda":
            raise ValueError(f"{op}: {name} is on {t.device}, expected {like.device} (CUDA)")
        want = torch.float32 if name in scalars else like.dtype
        if t.dtype != want:
            raise TypeError(f"{op}: {name} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned (vector loads)")
        if (t.numel() != 1) if name in scalars else (t.shape != like.shape):
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}")
    if like.numel() < 1:
        raise ValueError(f"{op}: empty tensors")


def _blocks(lib: ctypes.CDLL, n: int, dev) -> int:
    """A fixed grid that strides over the tensor: a few blocks on every SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-(n // 4) // lib.t4r_adafactor_threads()), _BLOCKS_PER_SM * sms))


def adafactor_pass_a(
    g: torch.Tensor,
    v: torch.Tensor,
    decay: torch.Tensor,
    lr: float,
    clipping_threshold: Optional[float] = 1.0,
    eps: float = 1e-30,
    group=None,
    numel: Optional[int] = None,
) -> torch.Tensor:
    """K7a: writes the new moment over ``v`` and returns the step's
    coefficient as a (1,) f32 tensor on the device (see
    ``adafactor_pass_a_plain``); g and v both f32 or both bf16. CUDA
    tensors launch the CUDA kernels
    (``adafactor_pass_a.launches`` counts the launches); CPU tensors run the
    plain version. With ``group`` (a row shard) the kernel's per-block sums
    are summed over the group and the coefficient taken from the total over
    ``numel`` elements."""
    if v.device.type == "cpu":
        return adafactor_pass_a_plain(g, v, decay, lr, clipping_threshold, eps, group, numel)
    _check_cuda_tensors("adafactor_pass_a", v, ("decay",), g=g, v=v, decay=decay)
    lib = _adafactor_lib()
    dev, n = v.device, v.numel()
    blocks = _blocks(lib, n, dev)
    part = torch.empty(blocks, dtype=torch.float32, device=dev)
    coef = torch.empty(1, dtype=torch.float32, device=dev)
    clip = clipping_threshold
    entry = lib.t4r_adafactor_a_bf16 if v.dtype == torch.bfloat16 else lib.t4r_adafactor_a
    with torch.cuda.device(dev):
        err = entry(g.data_ptr(), v.data_ptr(), decay.data_ptr(), float(eps), n,
                                  blocks, float(lr), float(clip or 1.0), int(clip is not None),
                                  part.data_ptr(), coef.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, err, "adafactor_a")
    adafactor_pass_a.launches += 1
    if group is not None and clip is not None:
        total = part.sum()
        dist.all_reduce(total, group=group)
        coef = _coef(total, numel or n, lr, clip)
    return coef


adafactor_pass_a.launches = 0


def adafactor_pass_b(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                     coef: torch.Tensor) -> None:
    """K7b: ``p += g·coef·rsqrt(v)`` in place, with ``coef`` a (1,) f32
    tensor on the device; p, g and v all f32 or all bf16 (the update then
    rounded to bf16 before the sum). CUDA tensors launch the CUDA kernel
    (``adafactor_pass_b.launches`` counts the launches); CPU tensors run the
    plain version."""
    if p.device.type == "cpu":
        return adafactor_pass_b_plain(p, g, v, coef)
    _check_cuda_tensors("adafactor_pass_b", p, ("coef",), p=p, g=g, v=v, coef=coef)
    lib = _adafactor_lib()
    dev, n = p.device, p.numel()
    entry = lib.t4r_adafactor_b_bf16 if p.dtype == torch.bfloat16 else lib.t4r_adafactor_b
    with torch.cuda.device(dev):
        err = entry(g.data_ptr(), v.data_ptr(), coef.data_ptr(), n,
                                  _blocks(lib, n, dev), p.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, err, "adafactor_b")
    adafactor_pass_b.launches += 1


adafactor_pass_b.launches = 0


def adafactor_update(
    p: torch.Tensor,
    g: torch.Tensor,
    v: torch.Tensor,
    decay: torch.Tensor,
    lr: float,
    clipping_threshold: Optional[float] = 1.0,
    eps: float = 1e-30,
    group=None,
    numel: Optional[int] = None,
) -> None:
    """K7a then K7b: one Adafactor step of the table ``p`` with gradient
    ``g`` and unfactored moment ``v`` (all f32, or all bf16), in two passes,
    in place on ``v`` and ``p``. ``decay`` is an f32 scalar tensor on the same device. The mean
    of the clip's rms goes over every element of ``p`` (of the whole table
    for a row shard: ``group`` and ``numel``). On CUDA tensors both
    passes are CUDA kernels; on CPU tensors their plain versions run."""
    adafactor_pass_b(p, g, v, adafactor_pass_a(g, v, decay, lr, clipping_threshold, eps,
                                               group, numel))


def _factored_dims(shape, min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """The second-largest and the largest axis, or None when the parameter
    is not factored (``optax``'s ``_factored_dims``)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])  # stable, as numpy's argsort
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


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
        if use_pallas and moment_dtype is not None:
            raise ValueError(
                "FusedAdafactor: use_pallas=True and moment_dtype are mutually exclusive "
                "(the streamed pass B reads the unrounded f32 moment)"
            )
        self.learning_rate = lr
        # the schedule itself stays out of the param groups: state_dict() holds
        # only what torch.save can write. group["lr"] is the last rate applied.
        defaults = dict(lr=float(lr(0)) if callable(lr) else float(lr), decay_rate=decay_rate,
                        clipping_threshold=clipping_threshold, eps=eps,
                        moment_dtype=moment_dtype, use_pallas=use_pallas,
                        min_dim_size_to_factor=min_dim_size_to_factor)
        super().__init__(params, defaults)
        # parameter -> process group, for the row shards of a table
        self.row_shards: Dict[torch.Tensor, object] = {}

    def _lr_at(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    def load_state_dict(self, state_dict) -> None:
        # the base class casts every state tensor to its parameter's dtype;
        # the moments go back to their storage dtype (bf16 -> f32 -> bf16 is exact)
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                for key in ("v", "v_row", "v_col"):
                    if key in self.state.get(p, {}):
                        self.state[p][key] = self.state[p][key].to(
                            group["moment_dtype"] or p.dtype)

    @staticmethod
    def _factored_step(p, g, state, dims, decay, lr, clip, eps, group=None) -> None:
        d1, d0 = dims
        sdtype = state["v_row"].dtype
        g2 = g * g
        if group is None:
            row_mean = g2.mean(dim=d0)
        elif d0 != 0:
            raise NotImplementedError("a factored row shard needs rows as its largest axis")
        else:
            # the mean over the whole table's rows
            row_mean = g2.sum(dim=0)
            dist.all_reduce(row_mean, group=group)
            row_mean = row_mean / (g2.shape[0] * dist.get_world_size(group))
        # mean(g² + eps) == mean(g²) + eps: eps is added after the reduction
        v_row = (decay * state["v_row"].float() + (1.0 - decay) * (row_mean + eps))
        v_col = (decay * state["v_col"].float() + (1.0 - decay) * (g2.mean(dim=d1) + eps))
        state["v_row"], state["v_col"] = v_row.to(sdtype), v_col.to(sdtype)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        vr32, vc32 = state["v_row"].float(), state["v_col"].float()
        rf = ((vr32 / vr32.mean(dim=reduced_d1, keepdim=True)) ** -0.5).unsqueeze(d0)
        cf = (vc32 ** -0.5).unsqueeze(d1)
        if clip is not None:
            # the update's rms without the update: mean((g·rf·cf)²)
            rms = torch.sqrt(FusedAdafactor._mean(g2 * (rf * rf) * (cf * cf), group))
            scale = 1.0 / torch.clamp_min(rms / clip, 1.0)
        else:
            scale = 1.0
        p.add_((g * ((-lr * scale) * rf) * cf).to(p.dtype))

    @staticmethod
    def _mean(t: torch.Tensor, group) -> torch.Tensor:
        """The mean of ``t``, of the whole table's for a row shard."""
        if group is None:
            return torch.mean(t)
        total = t.sum()
        dist.all_reduce(total, group=group)
        return total / (t.numel() * dist.get_world_size(group))

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
                dims = _factored_dims(p.shape, group["min_dim_size_to_factor"])
                state = self.state[p]
                if not state:
                    mdt = group["moment_dtype"] or p.dtype
                    state["step"] = 0
                    if dims is not None:
                        d1, d0 = dims
                        shape = list(p.shape)
                        state["v_row"] = torch.zeros(shape[:d0] + shape[d0 + 1:], dtype=mdt,
                                                     device=p.device)
                        state["v_col"] = torch.zeros(shape[:d1] + shape[d1 + 1:], dtype=mdt,
                                                     device=p.device)
                    else:
                        state["v"] = torch.zeros_like(p, dtype=mdt)
                step = state["step"]
                group["lr"] = lr = self._lr_at(step)
                shard_group = self.row_shards.get(p)
                numel = p.numel() * (1 if shard_group is None
                                     else dist.get_world_size(shard_group))
                # float32 scalars on the device, as the reference computes them
                decay = 1.0 - torch.full((), float(step + 1), dtype=torch.float32,
                                         device=p.device) ** -group["decay_rate"]
                if dims is not None:
                    self._factored_step(p, p.grad.float(), state, dims, decay, lr, clip, eps,
                                        shard_group)
                elif (group["use_pallas"] and p.dim() == 2
                        and p.shape[0] >= STREAMED_MIN_ROWS):
                    # the gradient as it is stored (f32, or a bf16 table's
                    # bf16): the kernels read it without a copy
                    adafactor_update(p, p.grad.contiguous(), state["v"], decay, lr, clip, eps,
                                     shard_group, numel)
                else:
                    g = p.grad.float()
                    new_v = (decay * state["v"].float() + (1.0 - decay) * (g * g + eps))
                    state["v"] = new_v.to(state["v"].dtype)
                    inv = torch.rsqrt(state["v"].float())
                    if clip is not None:
                        rms = torch.sqrt(self._mean((g * inv) ** 2, shard_group))
                        scale = 1.0 / torch.clamp_min(rms / clip, 1.0)
                    else:
                        scale = 1.0
                    p.add_((g * ((-lr * scale) * inv)).to(p.dtype))
                state["step"] = step + 1
        return loss
