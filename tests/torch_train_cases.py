"""One train-step comparison of the port against the JAX package, shared by
tests/test_torch_train_slice*.py: the reference's ``init_state`` carried
across with ``convert.train_state_from_jax``, the same numpy tokens, two
steps of ``jax.jit(repro.train.step.make_train_step)`` against two of the
port's ``make_train_step`` on the CPU.

The reference's gradients are read off its first step's moments: from zero
moments, m = (1 - b1) * g * scale with scale = min(1, clip / (grad_norm +
1e-9)), so g = m / ((1 - b1) * scale) to a float32 rounding or two (and
the second step's g from m2 - b1 * m1); this needs no second compile of
the reference's loss.

Tolerances (float32): loss, nll, aux and grad_norm 1e-5 relative; lr
1e-6; every gradient leaf 1e-4 of its largest magnitude; m and v after
each step 1e-5 relative plus 1e-4 of their largest magnitude; parameters
after each step 1e-5 relative (to the larger of the element before and
after the step, or lr: a zero-initialized element's first step is -lr u,
and a step may cancel an element to near zero), plus what the moments'
own differences (held to their tolerance above) move the update
lr m / (sqrt(v) + eps) by, plus the difference carried from the last
step.  The moments' part matters where the update is a ratio of small
numbers: at a gradient near zero (an element at 1.4e-4 of its leaf's
largest gradient, its clipped gradient 1.4e-8 against eps 1e-8, moved
3.5e-4 relative apart in hymba's A_log; at a gradient within the gradient
tolerance of zero m / sqrt(v) may even come out near +1 on one side and
-1 on the other, 2 lr apart), or where the second step's moment cancels
the first's.  The elements that need more than the 1e-5 and the carried
difference are counted: at most 1% of all.  bfloat16: loss 5e-2
relative, each gradient leaf 5e-2 relative in norm (the two frameworks
round to bf16 at other places: the port's attention keeps its
probabilities in float32, the reference casts them to bf16)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep

from torch_kernel_inputs import adamw_param_check

B, S = 4, 16


def _named(tcfg, tree):
    """{name: tensor} of a reference-layout tree through the port's map."""
    return {n: p.detach() for n, p in
            params_from_jax(tcfg, tree, device="cpu").named_parameters()}


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    labels[0, 9:] = -1                          # a padded sequence
    frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32) if cfg.is_enc_dec else None
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if frames is not None:
        jb["frames"] = jnp.asarray(frames)
        tb["frames"] = torch.from_numpy(frames)
    return jb, tb


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def run_case(arch, mb=1, dtype="float32", xent_chunk=0, start_step=0,
             warmup=0):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, microbatches=mb,
              xent_chunk=xent_chunk)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    max_seq = 32 if jcfg.pos == "learned" else 0
    opt = joptim.AdamWConfig(warmup_steps=warmup)
    st0 = jstep.init_state(jcfg, jax.random.key(0), max_seq)
    st0["step"] = jnp.asarray(start_step, jnp.int32)
    np0 = jax.tree.map(np.asarray, st0)
    jb, tb = _batch(jcfg)

    jts = jax.jit(jstep.make_train_step(jcfg, opt_cfg=opt))
    js1, jm1 = jts(st0, jb)
    js2, jm2 = jts(js1, jb)
    jstates = [jax.tree.map(np.asarray, s) for s in (js1, js2)]

    port = train_state_from_jax(tcfg, np0, device="cpu")
    _, _, tgrads = tstep.make_grad_fn(tcfg)(port["params"], tb)
    names = [n for n, _ in port["params"].named_parameters()]
    tts = tstep.make_train_step(tcfg, toptim.AdamWConfig(*opt))
    tsnaps, tms = [], []
    for _ in range(2):
        port, tm = tts(port, tb)
        tms.append(tm)
        tsnaps.append({"p": {n: p.detach().clone() for n, p in
                             port["params"].named_parameters()},
                       "m": {n: t.clone() for n, t in port["opt"]["m"].items()},
                       "v": {n: t.clone() for n, t in port["opt"]["v"].items()}})
    assert int(port["step"]) == start_step + 2

    bf16 = dtype == "bfloat16"
    m_tol = 5e-2 if bf16 else 1e-5
    for step, (jm, tm) in enumerate(zip((jm1, jm2), tms)):
        for k in ("loss", "nll", "aux", "grad_norm"):
            assert _rel(tm[k], jm[k]) <= m_tol or \
                abs(float(tm[k]) - float(jm[k])) <= 1e-7, \
                (arch, step, k, float(tm[k]), float(jm[k]))
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6, (step, float(tm["lr"]),
                                                  float(jm["lr"]))

    # the reference's gradients, from its moments
    b1 = opt.b1
    jm_named = [_named(tcfg, s["opt"]["m"]) for s in jstates]
    jv_named = [_named(tcfg, s["opt"]["v"]) for s in jstates]
    jp_named = [_named(tcfg, s["params"]) for s in jstates]
    g_ref = []
    for step, jm in enumerate((jm1, jm2)):
        scale = min(1.0, opt.grad_clip / (float(jm["grad_norm"]) + 1e-9))
        prev = {n: torch.zeros_like(t) for n, t in jm_named[0].items()} \
            if step == 0 else jm_named[0]
        g_ref.append({n: (jm_named[step][n] - b1 * prev[n])
                      / ((1 - b1) * scale) for n in names})
    for n, g in zip(names, tgrads):
        e = g_ref[0][n]
        if bf16:            # the leaf's relative error in norm
            err = float((g.float() - e).norm())
            assert err <= 5e-2 * float(e.norm()) + 1e-12, (arch, n, err)
            continue
        top = float(e.abs().max())
        err = float((g - e).abs().max())
        assert err <= 1e-4 * top + 1e-12, (arch, n, err, top)
    if bf16:
        return

    lr = [float(jm["lr"]) for jm in (jm1, jm2)]
    before = _named(tcfg, np0["params"])
    carried = {n: torch.zeros_like(before[n]) for n in names}
    n_loose = 0
    for step in range(2):
        snap = tsnaps[step]
        t = np.float32(start_step + step + 1)
        c1, c2 = (float(1 - np.float32(b) ** t) for b in (opt.b1, opt.b2))
        for n in names:
            for k, ref_named in (("m", jm_named), ("v", jv_named)):
                got, exp = snap[k][n], ref_named[step][n]
                bound = 1e-5 * exp.abs() + 1e-4 * float(exp.abs().max())
                assert bool(((got - exp).abs() <= bound).all()), \
                    (arch, step, k, n, float((got - exp).abs().max()))
            prev = (before if step == 0 else jp_named[0])[n].float()
            diff, bad, loose = adamw_param_check(
                snap["p"][n].float(), jp_named[step][n].float(), prev,
                snap["m"][n], jm_named[step][n], snap["v"][n],
                jv_named[step][n], lr[step], c1, c2, opt.eps, carried[n])
            assert bad == 0, (arch, step, n, float(diff.max()), bad)
            n_loose += loose
            carried[n] = diff
    total = sum(t.numel() for t in jp_named[0].values())
    assert n_loose <= 0.01 * 2 * total, (arch, n_loose, total)
