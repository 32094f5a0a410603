"""The pod ring at the cut, on a ('pod', 'data', 'model') = (2, 2, 2) mesh:
the reference's fault and the port's repair.

The reference's `_pod_permute` moves pod i's cut payload to pod i+1 and
nothing moves the labels or brings the rows back, so its pod-mesh logits
are its mesh-less logits rolled by B / n_pod rows along the batch, and
it trains each row against another row's labels. The port's
`cut_boundary_mesh` sends the payload the same way and scores each batch
shard against the labels of the rows it holds, so its (2, 2, 2) logits
(in the batch's row order) and loss equal the mesh-less ones.

The reference needs 8 devices, so the whole file runs one subprocess
with `XLA_FLAGS=--xla_force_host_platform_device_count=8`, as
tests/test_distributed.py runs it, at yi-6b SMOKE in f32: cut 1, topk
k 16 (no draws), batch 8 x seq 16, both packages from the reference's
weights (converted) and one numpy batch. Tolerance 2e-4, the
reference's own (tests/test_distributed.py:56).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

TOL = 2e-4

SCRIPT = """
import json
import numpy as np
import jax, jax.numpy as jnp
import torch
import repro.configs as jconfigs
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime, SplitConfig as JSplit
from repro.split import model as jsplit
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.split import model as split_model

torch.set_num_threads(1)
B, S = 8, 16
split = dict(cut_layer=1, compressor="topk", k=16)
jcfg = jconfigs.get("yi-6b", smoke=True).with_(split=JSplit(**split))
cfg = configs.get("yi-6b", smoke=True).with_(split=SplitConfig(**split))
jp = jtr.init_model(jax.random.key(0), jcfg)
params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
tok = np.random.RandomState(3).randint(0, cfg.vocab, (B, S)).astype(np.int32)
lab = np.roll(tok, -1, axis=1)
jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
axes = ("pod", "data", "model")
out = {"devices": jax.device_count()}

jrt0 = JRuntime(training=True)
l0, _ = jsplit.forward(jp, jcfg, jrt0, jb)
loss0 = float(jsteps.loss_fn(jp, jcfg, jrt0, jb, None)[0])
jmesh = jmake_mesh((2, 2, 2), axes)
with jmesh:
    jrt = JRuntime(mesh=jmesh, training=True)
    lm, _ = jax.jit(lambda p, b: jsplit.forward(p, jcfg, jrt, b))(jp, jb)
    lossm = float(jax.jit(lambda p, b: jsteps.loss_fn(
        p, jcfg, jrt, b, None)[0])(jp, jb))
l0, lm = np.asarray(l0), np.asarray(lm)
out["ref_mesh_vs_meshless"] = float(np.abs(lm - l0).max())
out["ref_mesh_vs_rolled"] = float(np.abs(
    lm - np.roll(l0, B // 2, axis=0)).max())
out["ref_loss_meshless"], out["ref_loss_mesh"] = loss0, lossm

with torch.no_grad():
    t0, _ = split_model.forward(params, cfg, Runtime(training=True), tb)
    for name, c in (("port", cfg), ("port_no_transfer", cfg.with_(
            split=SplitConfig(**split, transfer_over_pod=False)))):
        rt = Runtime(mesh=make_mesh((2, 2, 2), axes, devices="cpu"),
                     training=True)
        tm, _ = split_model.forward(params, c, rt, tb)
        tm = torch.cat(tm).numpy()
        out[name + "_mesh_vs_meshless"] = float(np.abs(
            tm - t0.numpy()).max())
        out[name + "_mesh_vs_ref_meshless"] = float(np.abs(tm - l0).max())
        out[name + "_loss"] = float(steps.loss_fn(
            params, c, rt, tb, torch.Generator())[0])
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def result():
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    for name in ("HOME", "TMPDIR"):
        if name in os.environ:
            env[name] = os.environ[name]
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(SCRIPT)],
                       capture_output=True, text=True, timeout=600,
                       cwd=root, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT "))
    out = json.loads(line[len("RESULT "):])
    assert out["devices"] == 8
    return out


def test_the_reference_pod_ring_rolls_the_rows(result):
    """The reference's (2, 2, 2) logits are its mesh-less logits rolled by
    B / n_pod rows, and not the mesh-less logits themselves; its loss
    differs from the mesh-less loss."""
    assert result["ref_mesh_vs_rolled"] <= TOL
    assert result["ref_mesh_vs_meshless"] > 100 * TOL
    assert abs(result["ref_loss_mesh"] - result["ref_loss_meshless"]) > TOL


@pytest.mark.parametrize("name", ["port", "port_no_transfer"])
def test_the_port_pod_ring_keeps_each_row_with_its_labels(result, name):
    """The port's (2, 2, 2) logits, in row order, and loss equal its own
    and the reference's mesh-less ones, the payload sent across the pod
    or not."""
    assert result[name + "_mesh_vs_meshless"] <= TOL
    assert result[name + "_mesh_vs_ref_meshless"] <= TOL
    assert abs(result[name + "_loss"] - result["ref_loss_meshless"]) <= TOL
