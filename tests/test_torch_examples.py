"""The PyTorch port's examples (`examples/torch_*.py`) stay runnable on the
CPU and print what `tests/test_examples.py` asserts of the reference's.

Four run whole, as scripts with `--device cpu` at their defaults (the
reference's sizes) and one torch thread: 4-25 s each on this CPU. The
multipod dry run is called through `main()` smaller, to stay within a
minute: it counts the qwen3-8b decode step on a (2, 2, 2) mesh instead
of the train step on (2, 16, 16) (a count of 512 positions takes
minutes; `examples/torch_multipod_dryrun.py` itself runs that).
"""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as the scripts get: small ops only lose to
    several on a busy machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(name, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example(name).main(**kw)
    return buf.getvalue()


def _script(name) -> str:
    r = subprocess.run(
        [sys.executable, os.path.join("examples", f"torch_{name}.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"},
        cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_quickstart_example():
    out = _script("quickstart")
    assert "compressed size" in out
    assert "greedy decode" in out
    assert "step  59 loss=" in out


def test_two_party_vfl_example():
    out = _script("two_party_vfl")
    assert "randtopk" in out and "size_reduction" in out


def test_streaming_clients_example():
    out = _script("streaming_clients")
    assert "identity" in out and "randtopk" in out
    assert "tok/s" in out


def test_fedtrain_two_party_example():
    out = _script("fedtrain_two_party")
    assert "randtopk" in out
    assert "B/step up" in out and "B/step down" in out
    assert "test acc" in out


def test_multipod_dryrun_example():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices="meta")
    out = _main("multipod_dryrun", shape="decode_32k", mesh=mesh)
    assert "== qwen3-8b x decode_32k mesh=2x2x2 (count " in out
    assert "summary:" in out and "'bottleneck':" in out
    assert "roofline:" in out and "collectives:" in out
