"""The port's dry run, ``python -m repro_torch.launch.dryrun``, in
subprocesses (a fake process group of 512 ranks, fake tensors; no card):
four cells through the CLI (hymba-1.5b ``train_4k``; moonshot
``train_4k``, MoE with 4 microbatches over 16 batch ranks; llama3.2-1b
``decode_32k``; xlstm-350m ``long_500k``, B = 1 with the batch
replicated), each JSON with the reference's keys, passing the
assertions of ``tests/test_system.py::test_dryrun_results_feed_fleet_bridge``
and carrying the reference's ``model_flops`` and parameter counts; and
rank 0's block shape of every parameter on the 16 x 16 mesh against
``NamedSharding.shard_shape`` of the reference's ``state_shardings``
(a JAX subprocess with 256 host devices; ``tests/conftest.py`` keeps
one in-process) for a dense and an MoE configuration; and the
weights-stationary decode cell (``--set serve_weights_stationary=True``)
traces and all-gathers less than the train layout's."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro import configs as jconfigs
from repro.models import config as jconfig
from repro.roofline import analysis as janalysis

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the reference's cell keys (roofline/analysis.py ``collect`` and
# launch/dryrun.py ``run_cells``)
REF_KEYS = {
    "arch", "shape", "kind", "chips", "mesh", "flops", "bytes_accessed",
    "collective_bytes", "collectives", "flops_scanned_module", "t_compute",
    "t_memory", "t_collective", "dominant", "step_time_est", "model_flops",
    "useful_flop_ratio", "roofline_fraction", "bytes_per_device", "memory",
    "t_lower", "t_compile", "params", "params_active", "cell", "tag"}
CELLS = [("hymba-1.5b", "train_4k"), ("moonshot-v1-16b-a3b", "train_4k"),
         ("llama3.2-1b", "decode_32k"), ("xlstm-350m", "long_500k")]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell's JSON and the CLI's output, the four run side by side."""
    procs = []
    for arch, shape in CELLS:
        out = tmp_path_factory.mktemp(shape)
        procs.append((arch, shape, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "pod", "--out", str(out)],
            env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    res = {}
    for arch, shape, out, p in procs:
        stdout, stderr = p.communicate(timeout=600)
        files = sorted(out.glob("*.json"))
        res[(arch, shape)] = (p.returncode, stdout, stderr,
                              [json.loads(f.read_text()) for f in files])
    return res


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_cell_traces_with_the_reference_schema(cells, arch, shape):
    rc, stdout, stderr, docs = cells[(arch, shape)]
    assert rc == 0, (stdout[-2000:], stderr[-4000:])
    assert "1/1 cells traced" in stdout
    (d,) = docs
    assert REF_KEYS <= set(d), sorted(REF_KEYS - set(d))
    assert "error" not in d
    # tests/test_system.py::test_dryrun_results_feed_fleet_bridge
    assert d["step_time_est"] > 0
    assert d["dominant"] in ("t_compute", "t_memory", "t_collective")
    assert 0 <= d["roofline_fraction"] <= 1.5
    assert set(d["collectives"]) == {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute"}
    jcfg = jconfigs.get_config(arch)
    shp = jconfig.SHAPES[shape]
    assert d["model_flops"] == janalysis.model_flops(jcfg, shp)
    assert d["params"] == jcfg.param_count()
    assert d["params_active"] == jcfg.param_count(active_only=True)
    assert d["chips"] == 256 and d["mesh"] == {"data": 16, "model": 16}
    assert d["memory"]["peak_bytes"] == d["bytes_per_device"] >= \
        d["memory"]["state_bytes"] > 0
    # the FSDP gathers of every leaf the batch axes split
    assert d["collectives"]["all-gather"] > 0
    if shp.kind == "train":
        assert d["collectives"]["reduce-scatter"] > 0
        assert d["flops"] > d["model_flops"] / d["chips"]


_PORT_SHAPES = r"""
import json
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
dryrun.init_fake(256)
mesh = make_production_mesh(device="cuda")
out = {}
with dryrun.fake_mode():
    for a in ("llama3_2_1b", "moonshot_v1_16b_a3b"):
        st = dryrun.state_specs(configs.get_config(a), mesh)
        out[a] = {n: list(p.shape) for n, p in
                  st["params"].named_parameters()}
print(json.dumps(out))
"""

_JAX_SHAPES = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import json, jax
from repro import configs
from repro.launch.mesh import make_production_mesh
from repro.train import step
mesh = make_production_mesh()
out = {}
for a in ("llama3_2_1b", "moonshot_v1_16b_a3b"):
    sh, shapes = step.state_shardings(configs.get_config(a), mesh)
    leaves = jax.tree_util.tree_leaves_with_path(shapes["params"])
    out[a] = [[[getattr(k, "key", getattr(k, "idx", None)) for k in p],
               list(s.shard_shape(l.shape))]
              for (p, l), s in zip(leaves,
                                   jax.tree_util.tree_leaves(sh["params"]))]
print(json.dumps(out))
"""


def _port_names(cfg, path, shard):
    """{port name: block shape} of one reference leaf: a pattern
    position's stack (or the encoder's) is a leaf a layer, its stacked dim
    unsplit."""
    if path[0] == "layers":
        _, j, *rest = path
        return {".".join(["layers", str(i), *rest]): tuple(shard[1:])
                for i in range(cfg.n_layers) if i % cfg.period == j}
    if path[:2] == ["enc", "layers"]:
        return {".".join(["enc", "layers", str(i), *path[2:]]):
                tuple(shard[1:]) for i in range(cfg.enc_layers)}
    return {".".join(path): tuple(shard)}


def test_shard_shapes_equal_the_references():
    runs = [subprocess.run([sys.executable, "-c", code], env=_env(),
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
            for code in (_PORT_SHAPES, _JAX_SHAPES)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    port, ref = (json.loads(r.stdout.strip().splitlines()[-1])
                 for r in runs)
    for arch, leaves in ref.items():
        cfg = jconfigs.get_config(arch)
        want = {}
        for path, shard in leaves:
            want.update(_port_names(cfg, path, shard))
        got = {n: tuple(s) for n, s in port[arch].items()}
        assert got == want, arch


def test_weights_stationary_decode_cell_records_its_item(cells, tmp_path):
    """The reference's decode layout under ``serve_rules``
    (``--set serve_weights_stationary=True``) traces: the CLI exits 0 with
    1/1 cells, and a decode step hands fewer bytes to all-gathers than
    the train layout's, whose FSDP blocks it gathers each step."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "decode_32k", "--mesh", "pod", "--set",
         "serve_weights_stationary=True", "--out", str(tmp_path)],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "1/1 cells traced" in r.stdout
    (f,) = tmp_path.glob("*.json")
    d = json.loads(f.read_text())
    assert "error" not in d
    _, _, _, (plain,) = cells[("llama3.2-1b", "decode_32k")]
    assert 0 < d["collectives"]["all-gather"] \
        < plain["collectives"]["all-gather"]
