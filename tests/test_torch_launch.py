"""The port's shared kernel launch path (`repro_torch.kernels._lib.launch`),
on the CPU with a fake library in place of the built CDLL: arguments pass
through to the launcher unchanged, a nonzero `cudaGetLastError()` raises,
every launch is counted exactly once (also from several threads at once),
and the build and the lookup of the launchers happen once, at the first
launch, never again."""
import ctypes
import sys
import threading

import pytest

from repro_torch.kernels import _lib


class _FakeFn:
    def __init__(self):
        self.calls = []
        self.code = 0

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _FakeLib:
    def __init__(self):
        for name in _lib.SIGNATURES:
            setattr(self, name, _FakeFn())


@pytest.fixture
def fake(monkeypatch):
    """A fake library behind `_lib._load`; returns (lib, loads), where
    loads[0] counts how often the library was loaded."""
    lib, loads = _FakeLib(), [0]

    def load():
        loads[0] += 1
        return lib

    monkeypatch.setattr(_lib, "_LIB", None)
    monkeypatch.setattr(_lib, "_FNS", {})
    monkeypatch.setattr(_lib, "_load", load)
    _lib.reset_launch_counts()
    yield lib, loads
    _lib.reset_launch_counts()


@pytest.mark.parametrize("name", sorted(_lib.SIGNATURES))
def test_launch_passes_arguments_and_resolves_signature(fake, name):
    lib, _ = fake
    args = tuple(range(len(_lib.SIGNATURES[name])))
    _lib.launch(name, *args)
    fn = getattr(lib, name)
    assert fn.calls == [args]
    assert fn.argtypes == list(_lib.SIGNATURES[name])
    assert fn.restype is ctypes.c_int
    assert _lib.launch_counts()[name] == 1


def test_launch_raises_on_error_and_does_not_count(fake):
    lib, _ = fake
    lib.scatter_rows.code = 700
    with pytest.raises(RuntimeError, match="scatter_rows.*cudaError 700"):
        _lib.launch("scatter_rows", 1, 2)
    assert _lib.launch_counts()["scatter_rows"] == 0
    lib.scatter_rows.code = 0
    _lib.launch("scatter_rows", 1, 2)
    assert _lib.launch_counts()["scatter_rows"] == 1


def test_launch_counts_each_launch_once_and_resets(fake):
    for _ in range(5):
        _lib.launch("decode_rows")
    _lib.launch("flash_attention")
    counts = _lib.launch_counts()
    assert counts["decode_rows"] == 5 and counts["flash_attention"] == 1
    assert sum(counts.values()) == 6
    _lib.reset_launch_counts()
    assert set(_lib.launch_counts().values()) == {0}


def test_launch_counts_exactly_from_many_threads(fake):
    """More threads than cores and a short switch interval: a count
    updated by read-modify-write would lose launches here."""
    n_threads, per_thread = 16, 2000

    def work():
        for _ in range(per_thread):
            _lib.launch("topk_mask_threshold")

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _lib.launch_counts()["topk_mask_threshold"] == \
        n_threads * per_thread


def test_launch_builds_and_resolves_once(fake, monkeypatch):
    lib, loads = fake
    for name in _lib.SIGNATURES:
        _lib.launch(name)
    assert loads[0] == 1

    def no_library():
        raise AssertionError("the launch path re-entered the build")

    monkeypatch.setattr(_lib, "library", no_library)
    for name in _lib.SIGNATURES:
        _lib.launch(name, 7)
        assert getattr(lib, name).calls[-1] == (7,)
    assert loads[0] == 1


def test_count_of_reads_without_advancing():
    import itertools

    c = itertools.count()
    for _ in range(3):
        next(c)
    assert _lib._count_of(c) == 3 and _lib._count_of(c) == 3
    assert next(c) == 3
