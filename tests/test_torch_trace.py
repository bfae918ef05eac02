"""The port's flight recorder piece by piece against the JAX package:
``trace.flush`` against ``repro.core.trace.flush`` on random staged lists
(both sides of the reference's 16-lane direct path, byte-aligned and
ragged segments, bursts, a pointer near and past the capacity, more
records than the capacity in one pass, every kind of payload, float32 and
float64 rings), the in-place ring's ownership rules, and the port's copy
of ``traceio`` (decode, lifecycle spans, critical path, the Chrome export
and ``diff_traces``' messages) on the port's final state against the
reference's on JAX's; ``simulate(profile=True)``'s run record.

Inputs are made with numpy from seeds.  Rings, pointers and drop counts
must be exactly equal."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import farm as jfarm
from repro.core import jobs as jjobs
from repro.core import trace as jtrace
from repro.core import traceio as jtio
from repro.core import types as jtypes
from repro_torch.core import engine as tengine
from repro_torch.core import farm as tfarm
from repro_torch.core import jobs as tjobs
from repro_torch.core import trace as ttrace
from repro_torch.core import traceio as ttio
from repro_torch.core import types as ttypes

from torch_port_util import (jax_run, jax_tree, net_scenario, port_cfg,
                             port_initial, port_simulate)

HERE = pathlib.Path(__file__).resolve().parent

# (name, segment sizes, set-lane density, capacity, starting pointer)
FLUSH_CASES = [
    ("direct_small", [3, 5], 0.5, 16, 0),
    ("direct_full_16", [7, 9], 1.0, 16, 5),
    ("byte_aligned", [8, 16, 24], 0.4, 64, 5),
    ("ragged_near_cap", [5, 13, 30, 1], 0.5, 64, 60),
    ("burst_over_cap", [200, 40], 0.9, 64, 0),
    ("past_cap", [24, 8, 1], 0.7, 16, 3 * 16 + 5),
    ("sparse_wide", [300], 0.03, 64, 7),
    ("one_lane_segments", [1, 1, 1, 1, 1], 0.6, 16, 14),
    ("empty_pass", [16, 3], 0.0, 64, 10),
]
PASSES = 3
# payload kinds, rotated over a segment's server / tid / aux columns
PAYLOADS = ("array", "none", "scalar", "arange", "zero_d", "float_array")


def _records(case, pass_i, clock64: bool):
    """The staged list of one pass, as numpy: [(mask, kind, server, tid,
    aux)] with each payload a numpy array, a Python number, ("arange", m)
    or None.  Deterministic in (case, pass)."""
    name, sizes, dens, _, _ = case
    rng = np.random.default_rng([FLUSH_CASES.index(case), pass_i])
    fdt = np.float64 if clock64 else np.float32
    out = []
    for s, m in enumerate(sizes):
        mask = rng.random(m) < dens
        kind = int(rng.integers(0, jtypes.TraceKind.NUM))
        pay = []
        for c in range(3):
            how = PAYLOADS[(s + c + pass_i) % len(PAYLOADS)]
            if how == "array":
                pay.append(rng.integers(-1, 5000, m).astype(np.int32))
            elif how == "none":
                pay.append(None)
            elif how == "scalar":
                pay.append([-1, 0, 7, 2.5][int(rng.integers(0, 4))])
            elif how == "arange":
                pay.append(("arange", m))
            elif how == "zero_d":
                pay.append(np.asarray(rng.uniform(-3, 3), fdt))
            else:
                pay.append(rng.uniform(-1e3, 1e3, m).astype(fdt))
        out.append((mask, kind, *pay))
    t = fdt(rng.uniform(0, 100))
    return out, t


def _start(case, clock64: bool):
    """A starting ring (random contents), pointer and drop count."""
    _, _, _, cap, ptr0 = case
    rng = np.random.default_rng([99, FLUSH_CASES.index(case)])
    fdt = np.float64 if clock64 else np.float32
    buf = rng.uniform(-5, 5, (cap, 5)).astype(fdt)
    return buf, np.int32(ptr0), np.int32(max(ptr0 - cap, 0))


def _jax_payload(p):
    if isinstance(p, tuple):
        return jnp.arange(p[1], dtype=jnp.int32)
    return jnp.asarray(p) if isinstance(p, np.ndarray) else p


def _port_payload(p):
    if isinstance(p, tuple):
        return torch.arange(p[1], dtype=torch.int32)
    return torch.from_numpy(np.array(p)) if isinstance(p, np.ndarray) else p


def jax_flush_case(case, clock64: bool):
    """The reference's ring after PASSES flushes: (buf, ptr, dropped)."""
    cap = case[3]
    cfg = jtypes.SimConfig(
        trace=jtypes.TraceConfig(enabled=True, capacity=cap),
        time_dtype=jnp.float64 if clock64 else jnp.float32)
    buf, ptr, dropped = _start(case, clock64)
    tr = jtypes.TraceState(buf=jnp.asarray(buf), ptr=jnp.asarray(ptr),
                           dropped=jnp.asarray(dropped))
    for i in range(PASSES):
        recs_np, t = _records(case, i, clock64)
        recs = []
        for mask, kind, srv, tid, aux in recs_np:
            jtrace.stage(recs, jnp.asarray(mask), kind, _jax_payload(srv),
                         _jax_payload(tid), _jax_payload(aux))
        tr = jtrace.flush(tr, cfg, jnp.asarray(t), recs)
    return np.asarray(tr.buf), int(tr.ptr), int(tr.dropped)


def port_flush_case(case, clock64: bool, alive_flags=None):
    """The port's ring after PASSES flushes, from the same start copied
    into a ring with its sentinel row (``own``)."""
    cap = case[3]
    cfg = ttypes.SimConfig(
        trace=ttypes.TraceConfig(enabled=True, capacity=cap),
        time_dtype=torch.float64 if clock64 else torch.float32)
    buf, ptr, dropped = _start(case, clock64)
    tr = ttrace.own(ttypes.TraceState(
        buf=torch.from_numpy(buf), ptr=torch.tensor(ptr),
        dropped=torch.tensor(dropped)), cfg)
    for i in range(PASSES):
        recs_np, t = _records(case, i, clock64)
        recs = []
        for mask, kind, srv, tid, aux in recs_np:
            ttrace.stage(recs, torch.from_numpy(mask), kind,
                         _port_payload(srv), _port_payload(tid),
                         _port_payload(aux))
        alive = None if alive_flags is None else torch.tensor(alive_flags[i])
        tr = ttrace.flush(tr, cfg, torch.tensor(t), recs, alive)
    return tr.buf.numpy(), int(tr.ptr), int(tr.dropped)


@pytest.mark.parametrize("case", FLUSH_CASES, ids=[c[0] for c in FLUSH_CASES])
def test_flush_matches_reference_f32(case):
    """Three passes of random staged records: ring, pointer and drop count
    bit-equal to the reference's (float32 ring)."""
    exp = jax_flush_case(case, False)
    got = port_flush_case(case, False)
    np.testing.assert_array_equal(got[0], exp[0])
    assert got[0].dtype == exp[0].dtype == np.float32
    assert got[1:] == exp[1:]


@pytest.fixture(scope="module")
def x64_flushes(tmp_path_factory):
    """The reference's flushes of every case on a float64 ring, computed in
    a subprocess (``jax_enable_x64`` is process-wide)."""
    tmp = tmp_path_factory.mktemp("flush64")
    code = (
        "import sys, numpy as np, jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import test_torch_trace as m\n"
        "for c in m.FLUSH_CASES:\n"
        "    buf, ptr, dr = m.jax_flush_case(c, True)\n"
        "    np.savez(f'{sys.argv[1]}/{c[0]}.npz', buf=buf, ptr=ptr, dr=dr)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           str(HERE)]))
    out = subprocess.run([sys.executable, "-c", code, str(tmp)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = {}
    for c in FLUSH_CASES:
        with np.load(tmp / f"{c[0]}.npz") as z:
            res[c[0]] = (z["buf"], int(z["ptr"]), int(z["dr"]))
    return res


@pytest.mark.parametrize("case", FLUSH_CASES, ids=[c[0] for c in FLUSH_CASES])
def test_flush_matches_reference_f64(case, x64_flushes):
    """The same passes on a float64 clock (a float64 ring) against the
    reference under jax_enable_x64."""
    exp = x64_flushes[case[0]]
    got = port_flush_case(case, True)
    assert got[0].dtype == exp[0].dtype == np.float64
    np.testing.assert_array_equal(got[0], exp[0])
    assert got[1:] == exp[1:]


def test_flush_closed_pass_writes_nothing():
    """A cheap pass the macro-step discards flushes under alive=False: the
    ring, pointer and drop count stay as they were, and an alive=True
    pass equals an unmasked one."""
    case = FLUSH_CASES[4]
    base = port_flush_case(case, False)
    got = port_flush_case(case, False, [True, False, True])
    assert got[1] < base[1]           # the second pass's records never land
    case_none = port_flush_case(case, False, [True, True, True])
    np.testing.assert_array_equal(case_none[0], base[0])
    assert case_none[1:] == base[1:]
    cap = case[3]
    cfg = ttypes.SimConfig(trace=ttypes.TraceConfig(enabled=True,
                                                    capacity=cap))
    tr = ttrace.init_trace(cfg, "cpu")
    before = tr.buf.clone()
    recs = []
    ttrace.stage(recs, torch.ones(40, dtype=torch.bool), 3,
                 torch.arange(40, dtype=torch.int32))
    out = ttrace.flush(tr, cfg, torch.tensor(1.0), recs, torch.tensor(False))
    assert out.buf is tr.buf
    assert torch.equal(tr.buf, before)
    assert int(out.ptr) == 0 and int(out.dropped) == 0


def test_ring_is_written_in_place_and_owned():
    """``init_trace``'s ring carries its sentinel row, so ``flush`` writes
    it in place and returns the same tensor; ``own`` copies it, so
    ``engine.run`` and ``engine.sim_step`` leave their input state's ring
    as it was."""
    cfg = ttypes.SimConfig(n_servers=2, n_cores=1, max_jobs=8,
                           events_per_step=1,
                           trace=ttypes.TraceConfig(enabled=True,
                                                    capacity=32))
    tr = ttrace.init_trace(cfg, "cpu")
    assert tr.buf.shape == (32, 5) and (tr.buf == -1).all()
    recs = []
    ttrace.stage1(recs, torch.tensor(True), ttypes.TraceKind.CTRL_TICK)
    out = ttrace.flush(tr, cfg, torch.tensor(0.5), recs)
    assert out.buf is tr.buf
    assert tr.buf[0].tolist() == [12.0, 0.5, -1.0, -1.0, 0.0]
    owned = ttrace.own(out, cfg)
    assert owned.buf.data_ptr() != out.buf.data_ptr()
    assert torch.equal(owned.buf, out.buf)
    with pytest.raises(ValueError, match="sentinel row"):
        ttrace.flush(dataclasses.replace(out, buf=out.buf.clone()), cfg,
                     torch.tensor(0.5), recs)

    jt = tjobs.build_jobs(cfg, np.asarray([0.0, 0.1]),
                          [tjobs.dag_single(0.2)] * 2, device="cpu")
    state, tc = tengine.init_state(cfg, jt)
    ring0 = state.trace.buf.clone()
    final = tengine.run(state, cfg, tc)
    one = tengine.sim_step(state, cfg, tc)
    assert torch.equal(state.trace.buf, ring0) and int(state.trace.ptr) == 0
    assert int(final.trace.ptr) > int(one.trace.ptr) > 0


def test_placeholder_when_off():
    """A disabled recorder is a (1, 5) placeholder of -1 in the ring's
    dtype, with the reference's values."""
    tr = ttrace.init_trace(ttypes.SimConfig(), "cpu")
    ref = jtrace.init_trace(jtypes.SimConfig())
    np.testing.assert_array_equal(tr.buf.numpy(), np.asarray(ref.buf))
    assert tr.buf.dtype == torch.float32
    assert int(tr.ptr) == 0 and int(tr.dropped) == 0
    f64 = ttrace.init_trace(ttypes.SimConfig(time_dtype=torch.float64), "cpu")
    assert f64.buf.shape == (1, 5) and f64.buf.dtype == torch.float64


def test_trace_kinds_match_reference():
    for name in dir(jtypes.TraceKind):
        if name.isupper():
            assert getattr(ttypes.TraceKind, name) == \
                getattr(jtypes.TraceKind, name), name
    assert ttypes.TraceKind.NAMES == jtypes.TraceKind.NAMES
    assert ttio.EVENT_DTYPE == jtio.EVENT_DTYPE


# --------------------------------------------------------------------------
# traceio on both engines' final states
# --------------------------------------------------------------------------

def _chain_runs():
    """tests/test_trace.py's two 2-chains contending for one core, traced,
    through both engines: (reference cfg, port cfg, JAX final, port
    final)."""
    jcfg = jtypes.SimConfig(
        n_servers=1, n_cores=1, max_jobs=8, tasks_per_job=2, max_children=2,
        sleep_policy=jtypes.SleepPolicy.ALWAYS_ON, max_events=1_000,
        trace=jtypes.TraceConfig(enabled=True))
    arr = np.asarray([0.0, 0.1])
    jfinal = jax_run(jcfg, arr, [jjobs.dag_chain([0.5, 0.25])] * 2)
    pcfg = port_cfg(jcfg)
    state, tc = port_initial(pcfg, arr, [tjobs.dag_chain([0.5, 0.25])] * 2)
    return jcfg, pcfg, jfinal, tengine.run(state, pcfg, tc)


def _star_runs():
    """The star network scenario, traced, through both engines (flows on
    the critical path)."""
    trace = jtypes.TraceConfig(enabled=True)
    jcfg, arr, jspecs, tau, _, jtopo = net_scenario("star_fluid", "jax",
                                                    trace=trace)
    pcfg, _, tspecs, _, _, ttopo = net_scenario("star_fluid", "port",
                                                trace=trace)
    jfinal = jax_run(jcfg, arr, jspecs, tau, None, jtopo)
    state, tc = port_initial(pcfg, arr, tspecs, tau, None, "cpu", ttopo)
    return jcfg, pcfg, jfinal, tengine.run(state, pcfg, tc)


@pytest.fixture(scope="module", params=["chains", "star"])
def finals(request):
    return _chain_runs() if request.param == "chains" else _star_runs()


def test_decode_spans_and_critical_path_match(finals):
    """decode, lifecycle_spans and critical_path of the port on its final
    state equal the reference's on JAX's."""
    jcfg, pcfg, jfinal, pfinal = finals
    jev, jdrop = jtio.decode(jfinal.trace, jcfg)
    pev, pdrop = ttio.decode(pfinal.trace, pcfg)
    assert pdrop == jdrop == 0 and len(pev) > 0
    np.testing.assert_array_equal(pev, jev)
    assert ttio.lifecycle_spans(pev, pfinal, pcfg) == \
        jtio.lifecycle_spans(jev, jfinal, jcfg)
    pcp = ttio.critical_path(pev, pfinal, pcfg)
    assert pcp == jtio.critical_path(jev, jfinal, jcfg)
    assert len(pcp) == int((np.asarray(jfinal.jobs.job_finish) < 1e29).sum())


def test_chrome_export_matches(finals, tmp_path):
    """The port's Chrome-trace document of its run equals the reference's
    of JAX's: every record exactly, the telemetry counter tracks within
    rtol 1e-5 (the windows are float sums that XLA may fuse)."""
    jcfg, pcfg, jfinal, pfinal = finals
    jev, _ = jtio.decode(jfinal.trace, jcfg)
    pev, n_drop = ttio.decode(pfinal.trace, pcfg)
    jdoc = jtio.to_chrome_trace(jev, jcfg, state=jfinal)
    pdoc = ttio.save_chrome_trace(str(tmp_path / "t.json"), pev, pcfg,
                                  state=pfinal, n_dropped=n_drop)
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads(json.dumps(pdoc))
    assert pdoc["otherData"] == jdoc["otherData"]
    assert pdoc["displayTimeUnit"] == jdoc["displayTimeUnit"]
    pe, je = pdoc["traceEvents"], jdoc["traceEvents"]
    assert len(pe) == len(je)
    phs = {e["ph"] for e in pe}
    assert {"M", "X", "C"} <= phs
    assert ("i" in phs) == pcfg.has_network      # the flows' instants
    for a, b in zip(pe, je):
        if a["ph"] == "C":
            assert {k: v for k, v in a.items() if k != "args"} == \
                {k: v for k, v in b.items() if k != "args"}
            for k in a["args"]:
                np.testing.assert_allclose(a["args"][k], b["args"][k],
                                           rtol=1e-5)
        else:
            assert a == b


def test_diff_traces_messages_match():
    """diff_traces of the port returns the reference's message, for a
    match, a planted divergence (a START record's server), a time skew
    past the tolerance and a truncated stream."""
    _, pcfg, jfinal, pfinal = _chain_runs()
    ev, _ = ttio.decode(pfinal.trace, pcfg)
    cases = [ev.copy()]
    bad = ev.copy()
    i = int(np.flatnonzero(bad["kind"] == ttypes.TraceKind.START)[-1])
    bad["server"][i] = 3
    cases.append(bad)
    skew = ev.copy()
    skew["time"][-1] += 1e-3
    cases.append(skew)
    cases.append(ev[:-2])
    msgs = []
    for other in cases:
        got = ttio.diff_traces(ev, other, time_tol=1e-4, check_aux=True,
                               names=("port", "jax"))
        exp = jtio.diff_traces(ev, other, time_tol=1e-4, check_aux=True,
                               names=("port", "jax"))
        assert got == exp
        msgs.append(got)
    assert msgs[0] is None
    assert all(m is not None for m in msgs[1:])
    assert "start" in msgs[1] and "server=3" in msgs[1]
    assert "extra event" in msgs[3]
    oracle = [(float(e["time"]), int(e["kind"]), int(e["server"]),
               int(e["tid"]), float(e["aux"])) for e in ev]
    np.testing.assert_array_equal(ttio.as_events(oracle),
                                  jtio.as_events(oracle))


def test_simulate_profile_fills_run_info():
    """simulate(profile=True) reruns the warm engine and records the first
    run's extra wall clock, as tests/test_trace.py::test_run_info_provenance
    asks of the reference; without it the field is NaN."""
    cfg = ttypes.SimConfig(n_servers=2, n_cores=1, max_jobs=16,
                           tasks_per_job=1,
                           sleep_policy=ttypes.SleepPolicy.ALWAYS_ON,
                           max_events=2_000)
    arr = np.asarray([0.0, 0.1])
    specs = [tjobs.dag_single(0.2), tjobs.dag_single(0.2)]
    res = tfarm.simulate(cfg, arr, specs, profile=True, device="cpu")
    ri = res.run_info
    assert ri.wall_s > 0.0
    assert ri.events == res.events > 0 and ri.steps > 0
    assert ri.events_per_s == pytest.approx(ri.events / ri.wall_s)
    assert ri.backend == "cpu"
    assert np.isfinite(ri.jit_compile_s) and ri.jit_compile_s >= 0.0
    assert ri.config["n_servers"] == 2
    assert ri.config["trace"]["enabled"] is False
    json.dumps(ri.config)
    assert np.isnan(tfarm.simulate(cfg, arr, specs,
                                   device="cpu").run_info.jit_compile_s)
    # a traced run reruns from the same initial ring
    tcfg = dataclasses.replace(cfg, trace=ttypes.TraceConfig(enabled=True))
    a = tfarm.simulate(tcfg, arr, specs, profile=True, device="cpu")
    b = tfarm.simulate(tcfg, arr, specs, device="cpu")
    np.testing.assert_array_equal(a.trace_events, b.trace_events)
    assert a.trace_dropped == b.trace_dropped == 0


def test_port_simulate_decodes_the_ring():
    """farm.simulate fills trace_events / trace_dropped through decode, and
    leaves them empty when the recorder is off."""
    jcfg, pcfg, jfinal, pfinal = _chain_runs()
    res, final = port_simulate(pcfg, np.asarray([0.0, 0.1]),
                               [tjobs.dag_chain([0.5, 0.25])] * 2)
    ev, n = ttio.decode(final.trace, pcfg)
    np.testing.assert_array_equal(res.trace_events, ev)
    assert res.trace_dropped == n == 0
    jres = jfarm.simulate(jcfg, np.asarray([0.0, 0.1]),
                          [jjobs.dag_chain([0.5, 0.25])] * 2)
    np.testing.assert_array_equal(res.trace_events, jres.trace_events)
    off = port_simulate(dataclasses.replace(pcfg, trace=ttypes.TraceConfig()),
                        np.asarray([0.0, 0.1]),
                        [tjobs.dag_chain([0.5, 0.25])] * 2)[0]
    assert off.trace_events is None and off.trace_dropped == 0
    assert jax_tree(jfinal)["trace.buf"].shape == tuple(final.trace.buf.shape)
