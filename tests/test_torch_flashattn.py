"""Port parity: the flash-attention kernel's plain version
(`repro_torch.kernels.flashattn`) against the reference's Pallas kernel
(interpret mode, bq = bk = 64) and its plain version, on the CPU, at the
four configurations of the reference's kernel tests in f32 and bf16; and
`models.attention.project_qkv` + the plain flash version against the
port's `full_attention` (and the reference's) on the yi-6b SMOKE config.
Inputs come from numpy with a seed and cross as data.

Tolerances are the reference tests' own: f32 atol 3e-5 (the Pallas
kernel's online softmax against one whole-row softmax), bf16 atol 3e-2
(the plain version rounds the softmax weights to bf16 before P.V, the
kernel keeps them in f32), the model comparison atol and rtol 3e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.flashattn import kernel as jkernel, ref as jref
from repro.models import attention as JA
from repro.models.config import Runtime as JRuntime
from repro_torch import configs
from repro_torch.kernels.flashattn import ops, ref
from repro_torch.models import attention as A
from repro_torch.models.config import Runtime

CONFIGS = [
    dict(B=2, S=128, Hq=4, Hkv=2, hd=64, causal=True, window=0),
    dict(B=1, S=256, Hq=8, Hkv=8, hd=32, causal=True, window=0),
    dict(B=2, S=128, Hq=4, Hkv=1, hd=64, causal=False, window=0),
    dict(B=1, S=256, Hq=4, Hkv=2, hd=64, causal=True, window=64),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 3e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(cfg, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(cfg["B"], cfg["S"], cfg["Hq"], cfg["hd"])
    k = rng.randn(cfg["B"], cfg["S"], cfg["Hkv"], cfg["hd"])
    v = rng.randn(cfg["B"], cfg["S"], cfg["Hkv"], cfg["hd"])
    return [a.astype(np.float32) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_flash_matches_reference_kernel(cfg, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    arrs = _qkv(cfg)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrs)
    kw = dict(causal=cfg["causal"], window=cfg["window"])
    got = ops.flash_attention(tq, tk, tv, bq=64, bk=64, **kw)
    assert got.dtype == tdt and got.shape == tq.shape
    want = jkernel.flash_attention(jq, jk, jv, bq=64, bk=64, **kw)
    g = got.float().numpy()
    np.testing.assert_allclose(g, np.asarray(want, np.float32), atol=atol)
    # the plain versions of both packages: the same arithmetic
    np.testing.assert_allclose(
        g, np.asarray(jref.attention(jq, jk, jv, **kw), np.float32),
        atol=1e-5 if dtype == "f32" else 1e-2)


def _smoke_layer():
    jcfg = jconfigs.get("yi_6b", smoke=True)
    p = JA.init_attention(jax.random.key(0), jcfg)
    tp = {k: torch.from_numpy(np.array(p[k])) for k in ("wq", "wk", "wv",
                                                           "wo")}
    x = np.random.RandomState(1).randn(2, 128, jcfg.d_model).astype(
        np.float32)
    return jcfg, p, tp, x


def test_project_qkv_matches_reference():
    jcfg, p, tp, x = _smoke_layer()
    cfg = configs.get("yi-6b", smoke=True)
    pos = np.arange(128)
    want = JA._project_qkv(p, jcfg, jnp.asarray(x), jnp.asarray(x),
                           pos[None], pos[None])
    got = A.project_qkv(tp, cfg, torch.from_numpy(x),
                        torch.arange(128)[None])
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def test_flash_matches_model_attention():
    """project_qkv + the flash version + wo against `full_attention` (the
    path the kernel would replace), as the reference's kernel test does."""
    jcfg, p, tp, x = _smoke_layer()
    cfg = configs.get("yi-6b", smoke=True)
    tx = torch.from_numpy(x)
    y_model = A.full_attention(tp, cfg, Runtime(attn_chunk=64), tx)
    q, k, v = A.project_qkv(tp, cfg, tx, torch.arange(128)[None])
    o = ops.flash_attention(q, k, v, bq=64, bk=64)
    y_flash = o.reshape(2, 128, -1) @ tp["wo"]
    np.testing.assert_allclose(y_flash.numpy(), y_model.numpy(), atol=3e-4,
                               rtol=3e-4)
    y_ref = JA.full_attention(p, jcfg, JRuntime(mesh=None, attn_chunk=64),
                              jnp.asarray(x))
    np.testing.assert_allclose(y_flash.numpy(), np.asarray(y_ref),
                               atol=3e-4, rtol=3e-4)


def test_flash_checks_tiling_and_backend():
    q = torch.zeros((1, 96, 2, 32))
    with pytest.raises(ValueError, match="multiple of bq"):
        ops.flash_attention(q, q, q, bq=64, bk=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q, bq=32, bk=32, backend="cuda")
    assert ops.smem_bytes(64, 64, 128) <= ops.MAX_SMEM
    assert ops.smem_bytes(128, 128, 128) > ops.MAX_SMEM


SHORT = dict(B=2, S=32, Hq=4, Hkv=2, hd=64, causal=True, window=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_short_sequence_matches_reference_kernel(dtype):
    """S below the bf16 kernel's own 128-row tile (its ragged-edge case on
    the card): the plain version against the Pallas kernel at bq = bk =
    S, with the reference tests' tolerances."""
    jdt, tdt, atol = DTYPES[dtype]
    arrs = _qkv(SHORT, seed=3)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrs)
    got = ops.flash_attention(tq, tk, tv, bq=32, bk=32)
    want = jkernel.flash_attention(jq, jk, jv, bq=32, bk=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.fixture
def fake_card(monkeypatch):
    """Drive the wrapper's kernel route on CPU tensors: the backend and
    device checks pass, launches are recorded (not run), and the plain
    version must not be called."""
    launches = []
    monkeypatch.setattr(ops._lib, "resolve_backend", lambda b, t: "cuda")
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops._lib, "stream_handle", lambda t: 0)
    monkeypatch.setattr(ops._lib, "launch",
                        lambda name, *args: launches.append((name, args)))

    def no_plain(*a, **kw):
        raise AssertionError("a kernel call fell back to the plain version")

    monkeypatch.setattr(ops.ref, "attention", no_plain)
    return launches


def test_flash_routes_bf16_to_tensor_cores_and_f32_to_simt(fake_card):
    cfg = dict(B=2, S=192, Hq=8, Hkv=2, hd=128)
    q = torch.zeros((2, 192, 8, 128))
    k = torch.zeros((2, 192, 2, 128))
    out = ops.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16(),
                              causal=False, window=64)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    name, args = fake_card[-1]
    assert name == "flash_attention"
    assert len(args) == len(ops._lib.SIGNATURES[name])
    assert args[3:10] == (cfg["B"], cfg["S"], cfg["Hq"], cfg["Hkv"],
                          cfg["hd"], 0, 64)
    assert args[10] == pytest.approx(np.log2(np.e) / np.sqrt(128), rel=1e-7)
    ops.flash_attention(q, k, k, bq=64, bk=32)
    name, args = fake_card[-1]
    assert name == "flash_attention_simt"
    assert len(args) == len(ops._lib.SIGNATURES[name])
    assert args[3:14] == (0, 2, 192, 8, 2, 128, 64, 32, 1, 0,
                          pytest.approx(128 ** -0.5))
    assert len(fake_card) == 2


def test_flash_bf16_takes_tiles_the_f32_kernel_cannot(fake_card):
    """The bf16 kernel keeps its own tiles: bq = bk = 128 at hd 128 passes
    the f32 kernel's 227 KB (which raises) but not the bf16 kernel's."""
    q = torch.zeros((1, 256, 4, 128))
    with pytest.raises(ValueError, match="shared memory"):
        ops.flash_attention(q, q, q, bq=128, bk=128)
    ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), bq=128,
                        bk=128)
    assert [n for n, _ in fake_card] == ["flash_attention"]


@pytest.mark.parametrize("case", ["head_dim", "mixed", "float16",
                                  "misaligned", "tiling"])
def test_flash_bf16_raises_and_never_falls_back(fake_card, case):
    shape = (1, 64, 4, 64)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    k = v = q
    err = ValueError
    if case == "head_dim":
        q = k = v = torch.zeros((1, 64, 4, 96), dtype=torch.bfloat16)
    elif case == "mixed":
        k, err = q.float(), TypeError
    elif case == "float16":
        q = k = v = q.half()
        err = TypeError
    elif case == "misaligned":               # contiguous, 2 bytes off
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(shape)
    elif case == "tiling":
        q = k = v = torch.zeros((1, 96, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(err):
        ops.flash_attention(q, k, v)
    assert fake_card == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backend_cuda_on_cpu_raises(dtype):
    q = torch.zeros((1, 64, 2, 32), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q, backend="cuda")


@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
def test_flash_tensor_core_smem_fits(hd):
    """Every head dim the bf16 kernel compiles fits one block's shared
    memory: the bf16 Q tile, three stages of K and V, 1 KB of alignment
    (the launcher's `tc_smem_bytes` in csrc/flash_attention.cu)."""
    hdp = max(hd, 64)
    assert ops.TC_STAGES == 3
    assert ops.tc_smem_bytes(hd) == 1024 + 2 * hdp * (
        ops.TC_ROWS + 2 * 3 * ops.TC_KEYS)
    assert ops.tc_smem_bytes(hd) <= ops.MAX_SMEM
