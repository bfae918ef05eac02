"""The training slice's parts against the JAX package, on the CPU:

* ``train/optim.py`` against ``repro.train.optim`` on random parameters,
  gradients and moments of a stacked reference tree and its per-layer
  port (``convert``), with a nonzero weight decay on nonzero norm scales,
  which pins the decay rule (every per-layer leaf decays, as every leaf of
  the reference's stacked layers has rank >= 2; the top-level vectors do
  not), inside warmup and on the cosine branch;
* ``lm_loss`` and ``lm_loss_chunked`` with padded labels (and a softcap
  for the chunked one), values and gradients against ``jax.grad``;
* both plain backward versions (``kernels/ref.py``) against
  ``torch.autograd`` of their plain forwards and ``jax.vjp`` of the
  reference's ``layers.attend`` and of the ``lax.scan`` of its
  ``mamba_mixer``, at ragged shapes with window, softcap, GQA, rows with
  no unmasked key and non-causal cases;
* ``remat`` "nothing", "dots" and "full" giving bit-equal gradients;
* one train step recorded by ``analysis/graph_audit.record``: no host
  sync, and the gradients through the backward ops.

Tolerances: float32 throughout.  The optimizer's update 1e-6 relative
plus 1e-6 of each leaf's largest magnitude (its cosine and ``b ** t`` are
rounded once in the port, XLA:CPU's are not correctly rounded, and XLA
contracts the moments' sums into FMAs, an ulp of the terms where they
cancel); the losses 1e-6; the plain backward versions 1e-6 of
the largest magnitude against autograd of the plain forward (the same
products in another order) and 1e-5 against the reference's vjp."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.train import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch.analysis import graph_audit
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as ttransformer
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep

torch.set_num_threads(1)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _random_tree(tree, rng, scale=1.0):
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                        .astype(np.float32), tree)


def _named(cfg, tree):
    """{port name: tensor} of a reference-layout numpy tree."""
    return {n: p.detach() for n, p in
            params_from_jax(cfg, tree, device="cpu").named_parameters()}


def _close(got, exp, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(exp, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

def test_decay_rule_follows_the_stacked_rank():
    v = torch.zeros(8)
    assert toptim.decays("layers.0.ln1", v)
    assert toptim.decays("layers.5.mixer.attn.bq", v)
    assert toptim.decays("enc.layers.1.ln2", v)
    assert not toptim.decays("final_norm", v)
    assert not toptim.decays("enc.final_norm", v)
    assert toptim.decays("embed", torch.zeros(4, 8))


@pytest.mark.parametrize("step", [3, 150, 12_000])
@pytest.mark.parametrize("arch", ["hymba_1_5b", "whisper_large_v3"])
def test_adamw_update_matches_reference(arch, step):
    """Random (nonzero) parameters, gradients and moments: the updated
    parameters and moments, grad_norm and lr of one AdamW step, at a step
    inside warmup, on the cosine and past total_steps."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **F32)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **F32)
    shapes, _ = jtransformer.make_params(jcfg, jax.random.key(0), 32)
    rng = np.random.default_rng(step)
    p = _random_tree(shapes, rng)
    g = _random_tree(shapes, rng, 0.01)
    m = _random_tree(shapes, rng, 0.01)
    v = jax.tree.map(np.abs, _random_tree(shapes, rng, 1e-4))
    cfg = joptim.AdamWConfig(weight_decay=0.1, grad_clip=1.0)
    jp, jmom, jstats = joptim.adamw_update(
        cfg, jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v)},
        jnp.asarray(step, jnp.int32))
    params = params_from_jax(tcfg, p, device="cpu")
    named = list(params.named_parameters())
    grads = _named(tcfg, g)
    mom = {"m": _named(tcfg, m), "v": _named(tcfg, v)}
    stats = toptim.adamw_update(toptim.AdamWConfig(*cfg), named,
                                [grads[n] for n, _ in named], mom,
                                torch.tensor(step, dtype=torch.int32))
    _close(stats["grad_norm"], jstats["grad_norm"], 1e-6)
    _close(stats["lr"], jstats["lr"], 1e-6)
    exp_p = _named(tcfg, jax.tree.map(np.asarray, jp))
    for k, tree in (("m", jmom["m"]), ("v", jmom["v"])):
        exp = _named(tcfg, jax.tree.map(np.asarray, tree))
        for n in exp:
            _close(mom[k][n], exp[n], 1e-6,
                   1e-6 * float(exp[n].abs().max()), f"{k} {n}")
    for n, t in named:
        _close(t.detach(), exp_p[n], 1e-6,
               1e-6 * float(exp_p[n].abs().max()), n)
    if step < cfg.warmup_steps:         # lr too small for the decay to
        return                          # stand above float32's rounding
    # the decay rule shows: a layer's norm scale moved by its decay
    n0 = "layers.0.ln1"
    no_decay = params_from_jax(tcfg, p, device="cpu")
    nd_named = list(no_decay.named_parameters())
    toptim.adamw_update(toptim.AdamWConfig(*cfg)._replace(weight_decay=0.0),
                        nd_named, [grads[n] for n, _ in nd_named],
                        {"m": _named(tcfg, m), "v": _named(tcfg, v)},
                        torch.tensor(step, dtype=torch.int32))
    nd = dict(nd_named)
    p0 = _named(tcfg, p)[n0]
    decay = (nd[n0] - exp_p[n0]).detach()          # lr * wd * p of the step
    ulps = 4e-7 * float(p0.abs().max())            # two roundings of p
    assert float(decay.abs().max()) > 5 * ulps
    _close(decay, float(stats["lr"]) * 0.1 * p0, 1e-2, ulps, "ln1's decay")
    # and the top-level norm scale has none
    assert torch.equal(nd["final_norm"], dict(named)["final_norm"])


def test_lr_schedule_matches_reference():
    cfg = joptim.AdamWConfig(warmup_steps=100, total_steps=1000)
    for s in (0, 1, 50, 99, 100, 101, 333, 999, 1000, 5000):
        exp = float(joptim.lr_at(cfg, jnp.asarray(s, jnp.int32)))
        got = float(toptim.lr_at(toptim.AdamWConfig(*cfg),
                                 torch.tensor(s, dtype=torch.int32)))
        _close(got, exp, 1e-6, what=f"step {s}")


# --------------------------------------------------------------------------
# the losses
# --------------------------------------------------------------------------

def test_lm_loss_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    labels[0, 5:] = -1
    labels[1, 0] = -1
    aux = np.float32(0.7)
    cfg = tconfigs.get_smoke("llama3_2_1b")

    def jloss(lg):
        return jtransformer.lm_loss(cfg, lg, jnp.asarray(labels),
                                    jnp.asarray(aux))
    (jl, jparts), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    loss, parts = ttransformer.lm_loss(cfg, tl, torch.from_numpy(labels),
                                       torch.tensor(aux))
    (tg,) = torch.autograd.grad(loss, tl)
    _close(loss.detach(), jl, 1e-6)
    _close(parts["nll"].detach(), jparts["nll"], 1e-6)
    _close(tg, jg, 1e-6, 1e-9)


@pytest.mark.parametrize("chunks,cap", [(3, 30.0), (1, 0.0), (9, 0.0)])
def test_lm_loss_chunked_matches_reference(chunks, cap):
    """Ragged chunks (7 positions in 3), one chunk, and more chunks than
    positions (the reference's empty chunks)."""
    rng = np.random.default_rng(chunks)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    head = rng.standard_normal((16, 50)).astype(np.float32) * 0.5
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    labels[1, 4:] = -1
    cfg = dataclasses.replace(jconfigs.get_smoke("gemma2_9b"),
                              xent_chunk=chunks)
    tcfg = dataclasses.replace(tconfigs.get_smoke("gemma2_9b"),
                               xent_chunk=chunks)

    def jloss(xx, hh):
        return jtransformer.lm_loss_chunked(
            cfg, xx, hh, jnp.asarray(labels), jnp.float32(0.1),
            final_softcap=cap)
    (jl, jparts), (jgx, jgh) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    loss, parts = ttransformer.lm_loss_chunked(
        tcfg, tx, th, torch.from_numpy(labels), torch.tensor(0.1),
        final_softcap=cap)
    gx, gh = torch.autograd.grad(loss, (tx, th))
    _close(loss.detach(), jl, 1e-6)
    _close(parts["nll"].detach(), jparts["nll"], 1e-6)
    _close(gx, jgx, 1e-5, 1e-7)
    _close(gh, jgh, 1e-5, 1e-7)


# --------------------------------------------------------------------------
# the plain backward versions
# --------------------------------------------------------------------------

ATTN_CASES = [   # B, H, KV, Sq, Skv, hd, causal, window, softcap
    (2, 4, 2, 37, 37, 16, True, 0, 0.0),        # ragged, GQA
    (1, 6, 2, 45, 45, 32, True, 9, 0.0),        # window
    (2, 4, 4, 30, 30, 16, True, 0, 5.0),        # softcap
    (1, 4, 1, 21, 33, 16, False, 0, 0.0),       # non-causal, Sq != Skv
    (1, 2, 1, 30, 9, 16, True, 4, 0.0),         # rows with no unmasked key
    (1, 2, 2, 13, 20, 16, False, 5, 2.0),       # non-causal window, softcap
]


def _attn_inputs(case, seed=0):
    B, H, KV, Sq, Skv, hd = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, hd), dtype=np.float32)
    k = rng.standard_normal((B, KV, Skv, hd), dtype=np.float32)
    v = rng.standard_normal((B, KV, Skv, hd), dtype=np.float32)
    do = rng.standard_normal((B, H, Sq, hd), dtype=np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", ATTN_CASES)
def test_mha_backward_reference(case):
    causal, window, cap = case[6:]
    kw = dict(causal=causal, window=window, softcap=cap)
    q, k, v, do = _attn_inputs(case)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ref.mha_reference(tq, tk, tv, **kw)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    lse = ref.mha_lse_reference(tq.detach(), tk.detach(), **kw)
    got = ref.mha_backward_reference(tq.detach(), tk.detach(), tv.detach(),
                                     out.detach(), lse, torch.from_numpy(do),
                                     **kw)
    again = ops._mha_backward_plain(tq.detach(), tk.detach(), tv.detach(),
                                    out.detach(), torch.from_numpy(do), **kw)
    # the reference's jnp attention, (B, S, H, hd), under jax.vjp
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    jout, vjp = jax.vjp(lambda a, b, c: jlayers.attend(
        a, b, c, causal=causal, window=window, attn_softcap=cap, chunk=0),
        tr(q), tr(k), tr(v))
    jg = [np.asarray(x).transpose(0, 2, 1, 3) for x in vjp(tr(do))]
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jout).transpose(0, 2, 1, 3),
                               rtol=1e-5, atol=1e-5)
    for name, g, a, g2, j in zip("qkv", got, auto, again, jg):
        scale = float(a.abs().max())
        _close(g, a, 0, 1e-6 * scale, f"d{name} vs autograd")
        assert torch.equal(g, g2)
        _close(g, j, 0, 1e-5 * scale, f"d{name} vs jax.vjp")


def _ssm_inputs(B, S, D, N, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(-3.0, 1.0, (B, S, D)))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    A = -(np.arange(1, N + 1, dtype=np.float32)[None]
          * rng.uniform(0.5, 1.5, (D, 1))).astype(np.float32)
    dy = rng.standard_normal((B, S, D), dtype=np.float32)
    dh = rng.standard_normal((B, D, N), dtype=np.float32)
    return (dt, Bm, Cm, x, A), dy, dh


def _jax_scan(dt, Bm, Cm, x, A):
    """The lax.scan of the reference's mamba_mixer, train form."""
    def step(h, inp):
        dt_t, B_t, C_t, x_t = inp
        da = jnp.exp(dt_t[..., None] * A[None])
        h = da * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
        return h, jnp.einsum("bdn,bn->bd", h, C_t)
    h0 = jnp.zeros((x.shape[0], x.shape[2], Bm.shape[-1]), jnp.float32)
    h, ys = jax.lax.scan(step, h0, tuple(a.transpose(1, 0, 2)
                                          for a in (dt, Bm, Cm, x)))
    return ys.transpose(1, 0, 2), h


@pytest.mark.parametrize("shape", [(2, 23, 7, 3), (1, 17, 5, 16),
                                   (2, 1, 4, 2)])
@pytest.mark.parametrize("with_dh", [False, True])
def test_ssm_scan_backward_reference(shape, with_dh):
    ins, dy, dh = _ssm_inputs(*shape)
    dh = dh if with_dh else None
    t_ins = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = ref.ssm_scan_reference(*t_ins)
    outs, cots = [y], [torch.from_numpy(dy)]
    if with_dh:
        outs.append(h)
        cots.append(torch.from_numpy(dh))
    auto = torch.autograd.grad(outs, t_ins, cots)
    plain_args = [torch.from_numpy(a) for a in ins]
    got = ref.ssm_scan_backward_reference(
        *plain_args, torch.from_numpy(dy),
        None if dh is None else torch.from_numpy(dh))
    (jy, jh), vjp = jax.vjp(_jax_scan, *map(jnp.asarray, ins))
    jg = vjp((jnp.asarray(dy), jnp.zeros_like(jh) if dh is None
              else jnp.asarray(dh)))
    for name, g, a, j in zip(("ddt", "dB", "dC", "dx", "dA"), got, auto, jg):
        scale = float(a.abs().max())
        _close(g, a, 0, 1e-6 * scale, f"{name} vs autograd")
        _close(g, np.asarray(j), 0, 1e-5 * scale, f"{name} vs jax.vjp")


# --------------------------------------------------------------------------
# remat, and the recorded step
# --------------------------------------------------------------------------

def _smoke_batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int64)], 1)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    if cfg.is_enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ["hymba_1_5b", "gemma2_9b",
                                  "whisper_large_v3", "xlstm_350m"])
def test_remat_does_not_change_gradients(arch):
    """Periods of one (hymba, xLSTM's mlstm/slstm pair is one period of
    two) and two blocks (gemma2's swa/attn), and whisper's encoder blocks:
    the loss and every gradient bit-equal under the three policies."""
    base = dataclasses.replace(tconfigs.get_smoke(arch), **F32)
    batch = _smoke_batch(base)
    got = {}
    for remat in ("nothing", "dots", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        params = ttransformer.make_params(
            cfg, torch.Generator().manual_seed(0), device="cpu", max_seq=32)
        tstep.train_state(params)
        got[remat] = tstep.make_grad_fn(cfg)(params, batch)
    loss0, _, g0 = got["nothing"]
    for remat in ("dots", "full"):
        loss, _, g = got[remat]
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(a, b) for a, b in zip(g, g0)), remat


def test_train_step_records_no_host_sync():
    """One train step of the hymba smoke config under the graph audit's
    recorder: no op reads the host, the LM kernels' forward and backward
    ops each appear once a layer (their plain versions inside
    kernel_ref/<name> on the CPU), and every metric is a 0-d tensor."""
    cfg = dataclasses.replace(tconfigs.get_smoke("hymba_1_5b"), **F32)
    state = tstep.init_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ts = tstep.make_train_step(cfg, opt_cfg=toptim.AdamWConfig(warmup_steps=0))
    inv = graph_audit.record(ts, state, _smoke_batch(cfg))
    assert inv.count(graph_audit.HOST_SYNC_OPS) == 0, [
        f"{s.op} at {s.src}" for s in inv.sites_of(graph_audit.HOST_SYNC_OPS)]
    folded = inv.folded()
    for name in ("flash_attention", "ssm_scan", "flash_attention_backward",
                 "ssm_scan_backward"):
        assert folded.count(graph_audit.as_opset([ops.OPS[name]])) == \
            cfg.n_layers, name
    new_state, metrics = inv.result
    assert int(new_state["step"]) == 1
    assert all(torch.is_tensor(v) and v.dim() == 0 for v in metrics.values())


def test_train_state_from_jax_carries_the_state():
    """Parameters, moments and step come across leaf for leaf."""
    from repro.train import step as jstep
    cfg = dataclasses.replace(jconfigs.get_smoke("gemma2_9b"), **F32)
    tcfg = dataclasses.replace(tconfigs.get_smoke("gemma2_9b"), **F32)
    st = jax.tree.map(np.asarray, jstep.init_state(cfg, jax.random.key(2)))
    rng = np.random.default_rng(0)
    st["opt"] = {"m": _random_tree(st["params"], rng),
                 "v": _random_tree(st["params"], rng)}
    st["step"] = np.int32(7)
    port = train_state_from_jax(tcfg, st, device="cpu")
    assert port["step"].dtype == torch.int32 and int(port["step"]) == 7
    names = [n for n, _ in port["params"].named_parameters()]
    assert all(p.requires_grad for p in port["params"].parameters())
    for k in ("m", "v"):
        exp = _named(tcfg, st["opt"][k])
        assert list(port["opt"][k]) == names
        assert all(torch.equal(port["opt"][k][n], exp[n]) for n in names)
