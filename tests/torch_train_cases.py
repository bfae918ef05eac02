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

With ``mesh_shape`` the port's two steps run sharded over spawned CPU
ranks (``tests/torch_spmd.py``'s ``mesh_train``), and its first-step
gradients are read off its own moments in the same way.

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


def _port_steps(tcfg, port, tb, opt):
    """(gradients of the first step, [snapshot], [metrics]) of two
    one-device port steps."""
    _, _, tgrads = tstep.make_grad_fn(tcfg)(port["params"], tb)
    tts = tstep.make_train_step(tcfg, opt_cfg=toptim.AdamWConfig(*opt))
    tsnaps, tms = [], []
    for _ in range(2):
        port, tm = tts(port, tb)
        tms.append(tm)
        tsnaps.append({"p": {n: p.detach().clone() for n, p in
                             port["params"].named_parameters()},
                       "m": {n: t.clone() for n, t in port["opt"]["m"].items()},
                       "v": {n: t.clone() for n, t in port["opt"]["v"].items()}})
    return tgrads, tsnaps, tms, int(port["step"])


def _mesh_steps(tcfg, port, tb, opt, mesh_shape):
    """The same from ``make_train_step(cfg, mesh)`` on spawned CPU ranks
    (gloo), the state gathered to full after each step; every rank's
    results equal.  The first step's gradients are read off its moments
    as the reference's are (see the module's note)."""
    import torch_spmd
    from repro_torch.core import shard_sim
    world = int(np.prod(mesh_shape))
    res = shard_sim.spawn(torch_spmd.mesh_train, world, (
        tcfg, torch_spmd.plain_state(port), [tb, tb],
        toptim.AdamWConfig(*opt), tuple(mesh_shape)))
    for other in res[1:]:
        for (m0, s0, _), (m1, s1, _) in zip(res[0], other):
            assert m0 == m1
            for k in ("m", "v"):
                for n, t in s0["opt"][k].items():
                    assert torch.equal(t, s1["opt"][k][n]), (k, n)
            for n, t in s0["params"].items():
                assert torch.equal(t, s1["params"][n]), n
    tms = [{k: torch.tensor(v) for k, v in m.items()} for m, _, _ in res[0]]
    tsnaps = [{"p": s["params"], "m": s["opt"]["m"], "v": s["opt"]["v"]}
              for _, s, _ in res[0]]
    scale = min(1.0, opt.grad_clip / (float(tms[0]["grad_norm"]) + 1e-9))
    names = [n for n, _ in port["params"].named_parameters()]
    tgrads = [tsnaps[0]["m"][n] / ((1 - opt.b1) * scale) for n in names]
    return tgrads, tsnaps, tms, int(res[0][-1][1]["step"])


def run_case(arch, mb=1, dtype="float32", xent_chunk=0, start_step=0,
             warmup=0, mesh_shape=None, batch=None):
    """Two steps of the port against two of the reference from one state
    on one batch (``batch``: (jax, torch) batches, ``_batch``'s by
    default).  ``mesh_shape`` (data, model): the port's steps run sharded
    over that many spawned CPU ranks."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype, microbatches=mb,
              xent_chunk=xent_chunk)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    max_seq = 32 if jcfg.pos == "learned" else 0
    opt = joptim.AdamWConfig(warmup_steps=warmup)
    st0 = jstep.init_state(jcfg, jax.random.key(0), max_seq)
    st0["step"] = jnp.asarray(start_step, jnp.int32)
    np0 = jax.tree.map(np.asarray, st0)
    jb, tb = batch or _batch(jcfg)

    jts = jax.jit(jstep.make_train_step(jcfg, opt_cfg=opt))
    js1, jm1 = jts(st0, jb)
    js2, jm2 = jts(js1, jb)
    jstates = [jax.tree.map(np.asarray, s) for s in (js1, js2)]

    port = train_state_from_jax(tcfg, np0, device="cpu")
    names = [n for n, _ in port["params"].named_parameters()]
    tgrads, tsnaps, tms, last = \
        _port_steps(tcfg, port, tb, opt) if mesh_shape is None else \
        _mesh_steps(tcfg, port, tb, opt, mesh_shape)
    assert last == start_step + 2

    # the reference's gradients, from its moments
    b1 = opt.b1
    jm_named = [_named(tcfg, s["opt"]["m"]) for s in jstates]
    g_ref = []
    for step, jm in enumerate((jm1, jm2)):
        scale = min(1.0, opt.grad_clip / (float(jm["grad_norm"]) + 1e-9))
        prev = {n: torch.zeros_like(t) for n, t in jm_named[0].items()} \
            if step == 0 else jm_named[0]
        g_ref.append({n: (jm_named[step][n] - b1 * prev[n])
                      / ((1 - b1) * scale) for n in names})
    ref = {"metrics": [jm1, jm2], "g": g_ref[0],
           "snaps": [{"p": _named(tcfg, s["params"]), "m": jm_named[i],
                      "v": _named(tcfg, s["opt"]["v"])}
                     for i, s in enumerate(jstates)]}
    before = _named(tcfg, np0["params"])
    bf16 = dtype == "bfloat16"
    _compare(arch, ref, tms, tgrads, tsnaps, names, opt, start_step, bf16,
             before)
    if mesh_shape is not None:        # and against the one-device step
        port = train_state_from_jax(tcfg, np0, device="cpu")
        g1, snaps1, tms1, _ = _port_steps(tcfg, port, tb, opt)
        one = {"metrics": tms1, "g": dict(zip(names, g1)), "snaps": snaps1}
        _compare(f"{arch} {mesh_shape} vs one device", one, tms, tgrads,
                 tsnaps, names, opt, start_step, bf16, before)


def _compare(tag, ref, tms, tgrads, tsnaps, names, opt, start_step, bf16,
             before):
    """The port's two steps (metrics ``tms``, first-step gradients
    ``tgrads`` in ``names`` order, snapshots ``tsnaps``) against ``ref``
    ({"metrics", "g" {name: gradient}, "snaps"}) within the module's
    tolerances; ``before`` the parameters both started from."""
    m_tol = 5e-2 if bf16 else 1e-5
    for step, (jm, tm) in enumerate(zip(ref["metrics"], tms)):
        for k in ("loss", "nll", "aux", "grad_norm"):
            assert _rel(tm[k], jm[k]) <= m_tol or \
                abs(float(tm[k]) - float(jm[k])) <= 1e-7, \
                (tag, step, k, float(tm[k]), float(jm[k]))
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6, (step, float(tm["lr"]),
                                                  float(jm["lr"]))
    for n, g in zip(names, tgrads):
        e = ref["g"][n]
        if bf16:            # the leaf's relative error in norm
            err = float((g.float() - e).norm())
            assert err <= 5e-2 * float(e.norm()) + 1e-12, (tag, n, err)
            continue
        top = float(e.abs().max())
        err = float((g - e).abs().max())
        assert err <= 1e-4 * top + 1e-12, (tag, n, err, top)
    if bf16:
        return

    lr = [float(jm["lr"]) for jm in ref["metrics"]]
    rs = ref["snaps"]
    carried = {n: torch.zeros_like(before[n]) for n in names}
    n_loose = 0
    for step in range(2):
        snap = tsnaps[step]
        t = np.float32(start_step + step + 1)
        c1, c2 = (float(1 - np.float32(b) ** t) for b in (opt.b1, opt.b2))
        for n in names:
            for k in ("m", "v"):
                got, exp = snap[k][n], rs[step][k][n]
                bound = 1e-5 * exp.abs() + 1e-4 * float(exp.abs().max())
                assert bool(((got - exp).abs() <= bound).all()), \
                    (tag, step, k, n, float((got - exp).abs().max()))
            prev = (before if step == 0 else rs[0]["p"])[n].float()
            diff, bad, loose = adamw_param_check(
                snap["p"][n].float(), rs[step]["p"][n].float(), prev,
                snap["m"][n], rs[step]["m"][n], snap["v"][n],
                rs[step]["v"][n], lr[step], c1, c2, opt.eps, carried[n])
            assert bad == 0, (tag, step, n, float(diff.max()), bad)
            n_loose += loose
            carried[n] = diff
    total = sum(t.numel() for t in rs[0]["p"].values())
    assert n_loose <= 0.01 * 2 * total, (tag, n_loose, total)


def mesh_runs(cfgs, mesh_shape, seed=0):
    """Two steps of ``make_train_step(cfg, mesh)`` of each configuration
    (the port's own ``init_state`` from a seeded generator, ``_batch``'s
    batch) on one spawn of ``prod(mesh_shape)`` CPU ranks, every rank's
    results equal: [(cfg, the full state before, the batch, rank 0's
    [(metrics, gathered state, {collective: calls})] a step)]."""
    import torch_spmd
    from repro_torch.core import shard_sim
    opt = toptim.AdamWConfig(warmup_steps=0)
    items = []
    for cfg in cfgs:
        max_seq = 32 if cfg.pos == "learned" else 0
        st = tstep.init_state(cfg, torch.Generator().manual_seed(seed),
                              max_seq=max_seq, device="cpu")
        _, tb = _batch(cfg)
        items.append((cfg, torch_spmd.plain_state(st), tb))
    res = shard_sim.spawn(torch_spmd.plan, int(np.prod(mesh_shape)), ([
        ("mesh_train", (cfg, plain, [tb, tb], opt, tuple(mesh_shape)))
        for cfg, plain, tb in items],))
    outs = res[0][0]
    for r, (other, mods) in enumerate(res):
        assert not mods, (r, mods)           # the port stands alone
        for case0, case in zip(outs, other):
            for (m0, s0, _), (m1, s1, _) in zip(case0, case):
                assert m0 == m1, r
                for k in ("m", "v"):
                    for n, t in s0["opt"][k].items():
                        assert torch.equal(t, s1["opt"][k][n]), (r, k, n)
                for n, t in s0["params"].items():
                    assert torch.equal(t, s1["params"][n]), (r, n)
    return [item + (steps,) for item, steps in zip(items, outs)]


def mesh_vs_one_device(run, mesh_shape):
    """One of ``mesh_runs``' cases held to two of the port's one-device
    steps from the same state, within the module's float32 bands (the
    mesh's first-step gradients read off its moments)."""
    import torch_spmd
    cfg, plain, tb, steps = run
    opt = toptim.AdamWConfig(warmup_steps=0)
    tms = [{k: torch.tensor(v) for k, v in m.items()} for m, _, _ in steps]
    tsnaps = [{"p": s["params"], "m": s["opt"]["m"], "v": s["opt"]["v"]}
              for _, s, _ in steps]
    scale = min(1.0, opt.grad_clip / (float(tms[0]["grad_norm"]) + 1e-9))
    names = list(plain["params"])
    tgrads = [tsnaps[0]["m"][n] / ((1 - opt.b1) * scale) for n in names]
    before = {n: t.clone() for n, t in plain["params"].items()}
    g1, snaps1, tms1, _ = _port_steps(cfg, torch_spmd.train_state_of(plain),
                                      tb, opt)
    one = {"metrics": tms1, "g": dict(zip(names, g1)), "snaps": snaps1}
    _compare(f"{cfg.name} {tuple(mesh_shape)} vs one device", one, tms,
             tgrads, tsnaps, names, opt, 0, False, before)
