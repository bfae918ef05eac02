"""Dispatch for the port's kernels, each registered as a ``torch.library``
op in the ``repro_torch`` namespace.

A registered op is one node to PyTorch's dispatcher: a recording under a
``TorchDispatchMode`` (``analysis/graph_audit.py``) sees each kernel call
as one ``repro_torch::<name>`` op, as the reference's jaxpr holds one
``pallas_call`` equation, and a fake implementation gives its output
shapes and dtypes without running it (the ``meta`` device, fake tensors;
inputs on more than one device raise).  None of the six writes its
arguments (no schema marks one written): each returns fresh outputs.
The two backward ops (``flash_attention_backward``, ``ssm_scan_backward``)
are the gradients of ``flash_attention`` and ``ssm_scan``, wired to them
by ``torch.autograd.Function``s that the entry points take only when a
gradient is wanted, so serving dispatches the forward ops as before.  The
scratch words of the engine kernels' in-kernel reductions are the
wrappers' own (``dcsim_step.scratch``, ``telemetry_bin.scratch``), not
arguments.

The ops are defined with ``torch.library.Library(..., "DEF")`` and one
``impl`` a device, not ``torch.library.custom_op``, whose Python layers
cost more host time a call of the engine's kernels on the H100 (PERF.md
section 6).

On a CUDA tensor each op runs the hand-written kernel's wrapper (which
raises on what it cannot take -- nothing falls back); on a CPU tensor the
plain PyTorch version in ``ref`` (a recording runs it inside the region
``kernel_ref/<name>``, ``core/regions.py``).  ``launch_counts`` reads
each kernel's launch counter (the wrappers count where they launch);
``reset_launch_counts`` zeroes them, flash attention's per-instance and
per-shape counts and the advance's per-clock counts.
"""
from __future__ import annotations

import torch

from . import dcsim_step, flash_attention as _fa, ref, ssm_scan as _ssm, \
    telemetry_bin

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")

# each op's CPU implementation, its plain version, by the name a recording
# writes ("repro_torch.dcsim_advance"; analysis/graph_audit.py runs it to
# see the plain version's ops)
PLAIN: dict = {}


def _one_device(name, *tensors):
    """The fake implementations' device check: a call whose inputs lie on
    more than one device raises, as each kernel's wrapper does."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) > 1:
        raise ValueError(f"{name}: inputs on more than one device "
                         f"({', '.join(sorted(map(str, devs)))})")


def _register(name, schema, kernel, plain, fake):
    """Define the op ``repro_torch::<name>``, which writes none of its
    arguments: ``kernel`` (the hand-written kernel's wrapper) on CUDA
    tensors, ``plain`` on CPU tensors, and ``fake`` for shapes and dtypes
    (the meta device, fake tensors).  No other device has a kernel: the
    dispatcher refuses it."""
    PLAIN[f"{NAMESPACE}.{name}"] = plain
    _LIB.define(name + schema)
    _LIB.impl(name, kernel, "CUDA")
    _LIB.impl(name, plain, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


def _dcsim_advance_fake(core_busy, srv_state, energy, busy_seconds, t,
                        t_next, state_power, p_core_active, p_core_idle,
                        srv_wake_at, srv_idle_since, srv_tau, throttled, *,
                        throttle_power_scale):
    _one_device("dcsim_advance", core_busy, srv_state, energy, busy_seconds,
                t, t_next, state_power, srv_wake_at, srv_idle_since, srv_tau,
                throttled)
    srv = core_busy.shape[:-1]
    return (torch.empty_like(core_busy),
            torch.empty_like(core_busy, dtype=torch.bool),
            energy.new_empty(srv, dtype=torch.float32),
            energy.new_empty(srv, dtype=torch.float32),
            core_busy.new_empty(core_busy.shape[:-2]))


_register(
    "dcsim_advance",
    "(Tensor core_busy, Tensor srv_state, Tensor energy, "
    "Tensor busy_seconds, Tensor t, Tensor t_next, Tensor state_power, "
    "float p_core_active, float p_core_idle, Tensor? srv_wake_at, "
    "Tensor? srv_idle_since, Tensor? srv_tau, Tensor? throttled, *, "
    "float throttle_power_scale) -> (Tensor, Tensor, Tensor, Tensor, "
    "Tensor)",
    dcsim_step.dcsim_advance, ref.dcsim_advance_reference,
    _dcsim_advance_fake)


def _telemetry_accum_fake(job_vals, job_wts, task_vals, task_wts, job_hist,
                          task_hist, win, widx, wvals, lo, hi):
    _one_device("telemetry_accum", job_vals, job_wts, task_vals, task_wts,
                job_hist, task_hist, win, widx, wvals)
    return (torch.empty_like(job_hist), torch.empty_like(task_hist),
            torch.empty_like(win))


_register(
    "telemetry_accum",
    "(Tensor job_vals, Tensor job_wts, Tensor task_vals, Tensor task_wts, "
    "Tensor job_hist, Tensor task_hist, Tensor win, Tensor widx, "
    "Tensor wvals, float lo, float hi) -> (Tensor, Tensor, Tensor)",
    telemetry_bin.telemetry_accum, ref.telemetry_accum_reference,
    _telemetry_accum_fake)


def _like(ref_t, t):
    """``t`` laid out like ``ref_t`` (a copy where the strides differ): the
    attention kernels return their outputs ``empty_like`` their inputs,
    so the plain versions do too, and the ops after them (a reshape of the
    transposed output) are the card's on the CPU."""
    if t.stride() == ref_t.stride():
        return t
    return torch.empty_like(ref_t, dtype=t.dtype).copy_(t)


def _mha_plain(q, k, v, *, causal, window, softcap):
    """The attention op's plain version, its output laid out like q."""
    return _like(q, ref.mha_reference(q, k, v, causal=causal, window=window,
                                      softcap=softcap))


def _flash_attention_fake(q, k, v, *, causal, window, softcap):
    _one_device("flash_attention", q, k, v)
    return torch.empty_like(q)


_register(
    "flash_attention",
    "(Tensor q, Tensor k, Tensor v, *, bool causal, int window, "
    "float softcap) -> Tensor",
    _fa.flash_attention, _mha_plain, _flash_attention_fake)


def _ssm_scan_fake(dt, Bm, Cm, x, A):
    _one_device("ssm_scan", dt, Bm, Cm, x, A)
    B, S, Dss = x.shape
    return (x.new_empty((B, S, Dss), dtype=torch.float32),
            x.new_empty((B, Dss, Bm.shape[-1]), dtype=torch.float32))


_register(
    "ssm_scan",
    "(Tensor dt, Tensor Bm, Tensor Cm, Tensor x, Tensor A) -> "
    "(Tensor, Tensor)",
    _ssm.ssm_scan, ref.ssm_scan_reference, _ssm_scan_fake)


def _mha_backward_plain(q, k, v, out, dout, *, causal, window, softcap):
    """The backward op's plain version: the row statistics recomputed, as
    the kernel does; dq, dk, dv laid out like q, k, v."""
    grads = ref.mha_backward_reference(q, k, v, out, None, dout,
                                       causal=causal, window=window,
                                       softcap=softcap)
    return tuple(_like(t, g) for t, g in zip((q, k, v), grads))


def _flash_attention_backward_fake(q, k, v, out, dout, *, causal, window,
                                   softcap):
    _one_device("flash_attention_backward", q, k, v, out, dout)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_register(
    "flash_attention_backward",
    "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor dout, *, "
    "bool causal, int window, float softcap) -> (Tensor, Tensor, Tensor)",
    _fa.flash_attention_backward, _mha_backward_plain,
    _flash_attention_backward_fake)


def _ssm_scan_backward_fake(dt, Bm, Cm, x, A, dy, dh):
    _one_device("ssm_scan_backward", dt, Bm, Cm, x, A, dy, dh)
    f32 = dict(dtype=torch.float32)
    return (x.new_empty(x.shape, **f32), Bm.new_empty(Bm.shape, **f32),
            Cm.new_empty(Cm.shape, **f32), x.new_empty(x.shape, **f32),
            A.new_empty(A.shape, **f32))


_register(
    "ssm_scan_backward",
    "(Tensor dt, Tensor Bm, Tensor Cm, Tensor x, Tensor A, Tensor dy, "
    "Tensor? dh) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _ssm.ssm_scan_backward, ref.ssm_scan_backward_reference,
    _ssm_scan_backward_fake)


# --------------------------------------------------------------------------
# gradients: the backward ops, wired to the forward ops by autograd
# --------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The attention op with its gradient: the forward op saves its inputs
    and output, the backward op recomputes the row statistics from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out = torch.ops.repro_torch.flash_attention(
            q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        if dout.stride(-1) != 1 or (dout.dtype == torch.bfloat16
                                    and not _fa.rows_aligned(dout)):
            # a fresh dense copy: the head dimension contiguous and rows
            # 16-byte aligned, as the backward's instances take them (q, k,
            # v and out passed the forward's plan)
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = torch.ops.repro_torch.flash_attention_backward(
            q, k, v, out, dout, **ctx.mask)
        return dq, dk, dv, None, None, None


class _SsmScan(torch.autograd.Function):
    """The scan op with its gradient; the final state's gradient is None
    when the state is not used (train mode), and the kernel then takes
    none."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, x, A):
        y, h = torch.ops.repro_torch.ssm_scan(dt, Bm, Cm, x, A)
        ctx.save_for_backward(dt, Bm, Cm, x, A)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        dt, Bm, Cm, x, A = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh is not None:
            dh = dh.contiguous()
        return torch.ops.repro_torch.ssm_scan_backward(dt, Bm, Cm, x, A, dy,
                                                       dh)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# --------------------------------------------------------------------------
# the port's entry points
# --------------------------------------------------------------------------

def dcsim_advance(core_busy, srv_state, energy, busy_seconds, t, t_next,
                  state_power, p_core_active, p_core_idle,
                  srv_wake_at=None, srv_idle_since=None, srv_tau=None,
                  throttled=None, *, throttle_power_scale=1.0):
    """Fused farm advance (see ``ref.dcsim_advance_reference``)."""
    return torch.ops.repro_torch.dcsim_advance(
        core_busy, srv_state, energy, busy_seconds, t, t_next, state_power,
        float(p_core_active), float(p_core_idle), srv_wake_at,
        srv_idle_since, srv_tau, throttled,
        throttle_power_scale=float(throttle_power_scale))


def telemetry_accum(job_vals, job_wts, task_vals, task_wts,
                    job_hist, task_hist, win, widx, wvals, lo, hi):
    """Fused histogram binning (see ``ref.telemetry_accum_reference``)."""
    return torch.ops.repro_torch.telemetry_accum(
        job_vals, job_wts, task_vals, task_wts, job_hist, task_hist, win,
        widx, wvals, float(lo), float(hi))


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Streaming-softmax attention, q (B, H, Sq, hd), k/v (B, KV, Skv, hd)
    (see ``ref.mha_reference``).  Where a gradient is wanted the call goes
    through ``_FlashAttention``, whose backward is the
    ``flash_attention_backward`` op; elsewhere (serving) it is the forward
    op alone."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                     float(softcap))
    return torch.ops.repro_torch.flash_attention(
        q, k, v, causal=bool(causal), window=int(window),
        softcap=float(softcap))


def ssm_scan(dt, Bm, Cm, x, A):
    """Selective-SSM scan returning (y, h_final) (see
    ``ref.ssm_scan_reference``); with a gradient wanted, through
    ``_SsmScan``, whose backward is the ``ssm_scan_backward`` op."""
    if _needs_grad(dt, Bm, Cm, x, A):
        return _SsmScan.apply(dt, Bm, Cm, x, A)
    return torch.ops.repro_torch.ssm_scan(dt, Bm, Cm, x, A)


# each kernel's launch counter: (module, attribute)
_COUNTERS = {"dcsim_advance": (dcsim_step, "LAUNCHES"),
             "telemetry_accum": (telemetry_bin, "LAUNCHES"),
             "flash_attention": (_fa, "LAUNCHES"),
             "ssm_scan": (_ssm, "LAUNCHES"),
             "flash_attention_backward": (_fa, "BWD_LAUNCHES"),
             "ssm_scan_backward": (_ssm, "BWD_LAUNCHES")}
# the forward kernels, which launch_counts reports by default; the
# backward kernels run in training only
FORWARD = ("dcsim_advance", "telemetry_accum", "flash_attention",
           "ssm_scan")
BACKWARD = ("flash_attention_backward", "ssm_scan_backward")
# the registered op of each kernel, by the name launch_counts uses
OPS = {name: f"{NAMESPACE}.{name}" for name in _COUNTERS}


def launch_counts(names=FORWARD) -> dict:
    """{kernel: launches since the last reset} of ``names`` (the forward
    kernels unless asked; ``FORWARD + BACKWARD`` for all six)."""
    return {name: getattr(*_COUNTERS[name]) for name in names}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
    dcsim_step.CLOCK_LAUNCHES.update(dict.fromkeys(dcsim_step.CLOCK_LAUNCHES,
                                                   0))
    _fa.INSTANCE_LAUNCHES.update(dict.fromkeys(_fa.INSTANCE_LAUNCHES, 0))
    _fa.BWD_INSTANCE_LAUNCHES.update(
        dict.fromkeys(_fa.BWD_INSTANCE_LAUNCHES, 0))
    _fa.SHAPE_LAUNCHES.clear()
    _fa.BWD_SHAPE_LAUNCHES.clear()
