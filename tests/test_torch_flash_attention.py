"""Port: flash attention (``repro_torch.kernels.flash_attention``).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there). Here the plain version, and the wrapper's CPU
route, are held to the JAX Pallas kernel in interpret mode and to
``attention_ref`` on the shapes of ``tests/test_kernels.py``, and to
``attention_ref`` alone on the ragged shapes and decode offsets that the
Pallas kernel's block divisibility refuses, and to the port's and JAX's
``chunked_attention`` with a sliding window; the wrapper's contract (the
kernel's dtypes, head dims and layouts), its choice of entry and the
decode split plan, and the arguments it passes each entry are tested.
"""
import collections
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import layers as TL

#: f32: sums of dh products in another order; bf16: the output's rounding
#: (tests/test_kernels.py's bounds for the Pallas kernel)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, Sq, Skv, H, Hkv, dh, causal): tests/test_kernels.py's sweep
SWEEP = [
    (1, 64, 64, 2, 2, 32, True),
    (2, 128, 128, 4, 2, 64, True),
    (1, 64, 128, 2, 1, 32, False),  # cross-attention-like
    (2, 1, 128, 4, 4, 32, True),  # decode: Sq=1
]


def _inputs(B, Sq, Skv, H, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, dh)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _fold(x, G):
    """[B, S, Hx, dh] -> [B * Hx * G, S, dh]: kv heads repeated G times, the
    JAX wrapper's layout."""
    B, S, Hx, dh = x.shape
    return torch.repeat_interleave(x, G, dim=2).permute(0, 2, 1, 3).reshape(B * Hx * G, S, dh)


def _ref(q, k, v, causal, q_offset, dtype=torch.float32):
    B, Sq, H, dh = q.shape
    G = H // k.shape[2]
    out = attention_ref(_fold(q, 1), _fold(k, G), _fold(v, G), causal=causal,
                        q_offset=q_offset, dtype=dtype)
    return out.reshape(B, H, Sq, dh).permute(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,dh,causal", SWEEP)
def test_plain_and_cpu_route_match_pallas_and_ref(B, Sq, Skv, H, Hkv, dh, causal, dtype):
    arrs = _inputs(B, Sq, Skv, H, Hkv, dh, seed=B * 100 + Sq + Skv + H)
    q_offset = Skv - Sq if causal else 0
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    pallas = jops.gqa_flash_attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                                      mode="interpret", block_q=32, block_k=32)
    G = H // Hkv
    fold = lambda x, g: jnp.repeat(x, g, axis=2).transpose(0, 2, 1, 3).reshape(  # noqa: E731
        B * H, -1, dh)
    jax_ref = jref.attention_ref(fold(jq, 1), fold(jk, G), fold(jv, G), causal=causal,
                                 q_offset=q_offset)
    jax_ref = np.asarray(jax_ref, np.float32).reshape(B, H, Sq, dh).transpose(0, 2, 1, 3)
    q, k, v = _torch(arrs, dtype)
    kf.reset_launches()
    for fn in (kf.flash_attention_torch, kf.flash_attention):
        out = fn(q, k, v, causal=causal, q_offset=q_offset)
        assert out.dtype == q.dtype and tuple(out.shape) == (B, Sq, H, dh)
        got = out.float().numpy()
        for want in (np.asarray(pallas, np.float32), jax_ref,
                     _ref(q, k, v, causal, q_offset).float().numpy()):
            np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    assert not kf.LAUNCHES  # the CPU route never counts a launch


# ragged lengths and decode offsets, which the Pallas kernel's divisibility
# assert refuses; (B, Sq, Skv, H, Hkv, dh, causal, q_offset)
RAGGED = [
    (2, 17, 45, 4, 2, 16, True, 28),  # ragged prompt against a ragged cache
    (1, 17, 17, 6, 3, 64, True, 0),
    (2, 17, 45, 4, 1, 32, False, 0),
    (3, 1, 45, 8, 2, 128, True, 0),  # decode at the start of the cache
    (3, 1, 45, 8, 2, 64, True, 30),  # decode mid-cache: rows past 30 unseen
    (3, 1, 45, 8, 2, 64, True, 44),  # decode at the last row
    (2, 5, 300, 32, 4, 64, True, 200),  # a tinyllama group (G = 8), kv tiles of 128
    (1, 3, 20, 24, 8, 128, True, 17),  # a llama3.2 group (G = 3)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,dh,causal,q_offset", RAGGED)
def test_ragged_and_decode_offsets_match_ref(B, Sq, Skv, H, Hkv, dh, causal, q_offset, dtype):
    q, k, v = _torch(_inputs(B, Sq, Skv, H, Hkv, dh, seed=Sq * 1000 + Skv + q_offset), dtype)
    want = _ref(q, k, v, causal, q_offset, dtype=torch.float64).double()
    got = ops.gqa_flash_attention(q, k, v, causal=causal, q_offset=q_offset, mode="torch")
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# sliding windows narrower than the rows a query sees; (B, Sq, Skv, H, Hkv,
# dh, causal, q_offset, window)
WINDOWED = [
    (2, 24, 24, 4, 2, 16, True, 0, 8),  # a prefill, tests/test_models_decode.py's window
    (2, 17, 45, 4, 2, 16, True, 28, 8),  # a chunk appended to a cache
    (3, 1, 45, 8, 2, 64, True, 40, 16),  # decode: rows below 25 outside the window
    (2, 5, 300, 32, 4, 64, True, 200, 130),  # kv tiles of 128: the first tile skipped
    (1, 9, 20, 6, 3, 32, True, 11, 1),  # a window of one: each query sees itself
    (1, 6, 12, 2, 1, 16, True, 6, 64),  # a window wider than the cache: no effect
    (2, 8, 30, 4, 2, 32, False, 0, 5),  # non-causal: a lower limit only
]


def _chunked(q, k, v, causal, q_offset, window, lib):
    """``chunked_attention`` of the port or of JAX on the model layout, from
    q [B, Sq, H, dh], over all Skv rows (kv_valid = Skv)."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    kw = dict(causal=causal, q_offset=q_offset, window=window, kv_valid=k.shape[1], chunk=4)
    if lib == "port":
        out = TL.chunked_attention(q.reshape(B, Sq, Hkv, H // Hkv, dh), k, v, **kw)
        return out.reshape(B, Sq, H, dh).float().numpy()
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16 if q.dtype == torch.bfloat16
                              else jnp.float32) for x in (q, k, v))
    out = JL.chunked_attention(jq.reshape(B, Sq, Hkv, H // Hkv, dh), jk, jv, **kw)
    return np.asarray(out, np.float32).reshape(B, Sq, H, dh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,dh,causal,q_offset,window", WINDOWED)
def test_window_matches_chunked_attention(B, Sq, Skv, H, Hkv, dh, causal, q_offset, window,
                                          dtype):
    """The plain version and the CPU route with a window against the port's
    and JAX's ``chunked_attention`` with the same window (the JAX models'
    attention; its P.V in the input dtype rounds once more in bf16)."""
    q, k, v = _torch(_inputs(B, Sq, Skv, H, Hkv, dh, seed=Sq * 7 + Skv + window), dtype)
    kw = dict(causal=causal, q_offset=q_offset, window=window)
    kf.reset_launches()
    for fn in (kf.flash_attention_torch, kf.flash_attention):
        got = fn(q, k, v, **kw)
        assert got.dtype == q.dtype and tuple(got.shape) == (B, Sq, H, dh)
        for lib in ("port", "jax"):
            np.testing.assert_allclose(got.float().numpy(),
                                       _chunked(q, k, v, causal, q_offset, window, lib),
                                       atol=TOL[dtype], rtol=TOL[dtype])
    assert not kf.LAUNCHES


def test_window_masks_rows_below_it():
    """Rows below every query's window change nothing (the kernel never
    reads them), rows inside it do; ``first_visible_row`` is the first row
    any query sees."""
    q, k, v = _torch(_inputs(2, 3, 40, 4, 2, 16, seed=9), "float32")
    kw = dict(causal=True, q_offset=30, window=8)
    assert kf.first_visible_row(30, 8) == 23 and kf.first_visible_row(30, 0) == 0
    assert kf.first_visible_row(3, 8) == 0
    a = kf.flash_attention(q, k, v, **kw)
    k2, v2 = k.clone(), v.clone()
    k2[:, :23] = 1e4
    v2[:, :23] = float("nan")
    assert torch.equal(kf.flash_attention(q, k2, v2, **kw), a)
    k2[:, 23] = 5.0
    assert not torch.equal(kf.flash_attention(q, k2, v2, **kw), a)
    with pytest.raises(ValueError, match="window"):
        kf.flash_attention(q, k, v, window=-1)


def test_unseen_cache_rows_do_not_matter():
    """Causal decode reads only rows <= q_offset: garbage past them (the
    cache's unwritten rows) changes nothing."""
    q, k, v = _torch(_inputs(2, 1, 40, 8, 2, 32, seed=4), "bfloat16")
    a = kf.flash_attention(q, k, v, causal=True, q_offset=20)
    k[:, 21:] = float("nan")
    v[:, 21:] = float("inf")
    b = kf.flash_attention(q, k, v, causal=True, q_offset=20)
    assert torch.equal(a, b)


def test_float32_q_reads_a_bf16_cache():
    """The float32-compute model reads its bf16 KV cache: the same values as
    casting the cache to float32 first."""
    arrs = _inputs(2, 3, 24, 4, 2, 16, seed=6)
    q = torch.from_numpy(arrs[0])
    k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs[1:])
    got = kf.flash_attention(q, k, v, causal=True, q_offset=21)
    assert got.dtype == torch.float32
    want = kf.flash_attention(q, k.float(), v.float(), causal=True, q_offset=21)
    assert torch.equal(got, want)


def test_modes_and_contract():
    q, k, v = _torch(_inputs(1, 4, 8, 2, 1, 16, seed=2), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gqa_flash_attention(q, k, v, mode="cuda")
    with pytest.raises(ValueError, match="mode"):
        ops.gqa_flash_attention(q, k, v, mode="jnp")
    bad = [
        ((q[..., :12], k[..., :12], v[..., :12]), ValueError),  # dh not in 16/32/64/128
        ((q.double(), k, v), TypeError),
        ((q, k.half(), v.half()), TypeError),
        ((q.bfloat16(), k, v), TypeError),  # bf16 q, float32 kv
        ((q, k, v.bfloat16()), TypeError),  # k and v differ
        ((q, k.transpose(1, 3).contiguous().transpose(1, 3), v), ValueError),  # dim stride
        ((q, k[:, :, :, 1:], v[:, :, :, 1:]), ValueError),
        ((torch.zeros(1, 4, 3, 16), k, v), ValueError),  # 3 heads over 1 kv head is fine ...
    ]
    for args, err in bad[:-1]:
        with pytest.raises(err):
            kf.flash_attention(*args)
    assert kf.flash_attention(*bad[-1][0]).shape == (1, 4, 3, 16)  # ... G = 3
    with pytest.raises(ValueError, match="group"):
        kf.flash_attention(torch.zeros(1, 4, 3, 16), torch.zeros(1, 8, 2, 16),
                           torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="q_offset"):
        kf.flash_attention(q, k, v, q_offset=-1)
    # meta tensors (the dry run): the output's shape, no launch
    kf.reset_launches()
    out = kf.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert not kf.LAUNCHES


# ---- the wrapper's choice of kernel entry and the decode split plan ----

@pytest.mark.parametrize("dh", kf.HEAD_DIMS)
@pytest.mark.parametrize("q_dtype,kv_dtype,Sq,want", [
    (torch.float32, torch.float32, 512, "simt"),
    (torch.float32, torch.float32, 1, "simt"),
    (torch.float32, torch.bfloat16, 512, "simt"),
    (torch.float32, torch.bfloat16, 1, "simt"),
    (torch.bfloat16, torch.bfloat16, 512, "mma"),
    (torch.bfloat16, torch.bfloat16, 17, "mma"),
    (torch.bfloat16, torch.bfloat16, 2, "mma"),
    (torch.bfloat16, torch.bfloat16, 1, "mma_split"),
])
def test_entry_by_dtypes(q_dtype, kv_dtype, Sq, want, dh):
    """Every bf16 call takes a tensor-core entry, the split one at decode;
    a float32 q stays on the CUDA cores, whatever its cache's dtype."""
    assert kf.entry(q_dtype, kv_dtype, Sq) == want
    assert want in kf.ENTRIES


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# every decode shape of chip_smoke.FLASH_SHAPES, and decode offsets and
# windows around the tile edges; (B, Skv, H, Hkv, q_offset, window)
DECODES = [(B, Skv, H, Hkv, off, win) for _, B, Sq, Skv, H, Hkv, _, _, off, win
           in _chip_smoke().FLASH_SHAPES if Sq == 1] + [
    (8, 672, 32, 4, 63, 0), (8, 672, 32, 4, 64, 0), (8, 672, 32, 4, 671, 0),
    (8, 672, 32, 4, 700, 0), (1, 45, 8, 2, 30, 0), (2, 200, 32, 1, 150, 0),
    (8, 672, 32, 8, 511, 1), (8, 672, 32, 8, 511, 65), (8, 672, 32, 8, 100, 64),
    (1, 4096, 32, 8, 4095, 0), (64, 672, 32, 4, 511, 0),
]


def split_ranges(Skv, q_offset, window, splits, rows):
    """The kv rows [start, end) split i of a causal decode step (Sq = 1)
    reads, by the launcher's contract: [base + i rows, base + (i + 1) rows)
    cut to the visible rows, base the first visible row's tile."""
    lo, hi = kf.first_visible_row(q_offset, window), kf.visible_rows(1, Skv, True, q_offset)
    base = lo // kf.KV_TILE * kf.KV_TILE
    return [(max(lo, base + i * rows), min(hi, base + (i + 1) * rows)) for i in range(splits)]


@pytest.mark.parametrize("B,Skv,H,Hkv,q_offset,window", DECODES)
def test_split_plan_reads_every_visible_row_once(B, Skv, H, Hkv, q_offset, window):
    splits, rows = kf.split_plan(B, 1, Skv, H, Hkv, True, q_offset, window)
    assert splits >= 1 and rows > 0 and rows % kf.KV_TILE == 0
    ranges = split_ranges(Skv, q_offset, window, splits, rows)
    seen = collections.Counter(j for lo, hi in ranges for j in range(lo, hi))
    lo, hi = kf.first_visible_row(q_offset, window), kf.visible_rows(1, Skv, True, q_offset)
    assert seen == collections.Counter(range(lo, hi))  # each visible row exactly once
    assert all(lo < hi for lo, hi in ranges)  # no split is empty
    ctas = B * Hkv * splits * -(-(H // Hkv) // kf.SPLIT_ROWS)
    tiles = -(-(hi - lo // kf.KV_TILE * kf.KV_TILE) // kf.KV_TILE)
    # fills the card where there are tiles for it, within the rounding of
    # whole tiles per split
    assert 2 * ctas >= min(kf.TARGET_CTAS, B * Hkv * tiles)


def test_split_plan_at_the_serving_decode():
    """tinyllama's decode@511 (B 8, Hkv 4, 512 rows): >= 132 CTAs."""
    splits, rows = kf.split_plan(8, 1, 672, 32, 4, True, 511, 0)
    assert 8 * 4 * splits >= 132 and splits * rows >= 512


class _FakeFn:
    """One launcher of ``_FakeLib``: records its arguments, takes the
    ``argtypes`` and ``restype`` that ``kf.bind`` declares."""

    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


class _FakeLib:
    """Records the launchers' arguments in place of the built library."""

    def __init__(self):
        self.calls = []
        self.flash_attention_launch = _FakeFn(self.calls, "simt")
        self.flash_attention_mma_launch = _FakeFn(self.calls, "mma")
        self.flash_attention_error_string = _FakeFn(self.calls, "error_string")


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,dh,q_offset,window,qdt", [
    (2, 17, 70, 4, 2, 16, 20, 0, "bfloat16"),
    (2, 1, 70, 8, 2, 64, 60, 0, "bfloat16"),
    (1, 1, 300, 32, 8, 128, 250, 64, "bfloat16"),
    (2, 5, 40, 4, 2, 32, 30, 0, "float32"),
])
def test_launch_passes_each_entry_its_arguments(B, Sq, Skv, H, Hkv, dh, q_offset, window, qdt):
    q, k, v = _torch(_inputs(B, Sq, Skv, H, Hkv, dh, seed=1), qdt)
    lib = kf.bind(_FakeLib())
    name, out = kf.launch(lib, q, k, v, True, q_offset, window, 0)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert name == kf.entry(q.dtype, k.dtype, Sq)
    (fn, args), = lib.calls
    assert fn == ("simt" if name == "simt" else "mma")
    # as many arguments as the C signature that ``bind`` declares
    launcher = lib.flash_attention_launch if fn == "simt" else lib.flash_attention_mma_launch
    assert len(args) == len(launcher.argtypes)
    if fn == "mma":
        part, dh_arg, shape = args[4], args[5], args[6:11]
        splits, rows = args[-3:-1]
        assert (dh_arg, shape) == (dh, (B, Sq, Skv, H, Hkv))
        want = kf.split_plan(B, Sq, Skv, H, Hkv, True, q_offset, window) if Sq == 1 else (0, 0)
        assert (splits, rows) == want
        assert (part != 0) == (Sq == 1)
    else:
        assert args[4:6] == (0, dh)  # float32 k/v



class _FailingLib(_FakeLib):
    """A library whose launchers return a CUDA error code."""

    def __init__(self):
        super().__init__()
        self.flash_attention_launch = lambda *args: 9
        self.flash_attention_mma_launch = lambda *args: 9
        self.flash_attention_error_string = lambda err: b"invalid configuration argument"


@pytest.mark.parametrize("qdt,Sq", [("float32", 4), ("bfloat16", 4), ("bfloat16", 1)])
def test_launch_raises_on_a_launcher_error(qdt, Sq):
    """No entry's failure passes silently: the code and its message raise."""
    q, k, v = _torch(_inputs(1, Sq, 8, 2, 1, 16, seed=3), qdt)
    with pytest.raises(RuntimeError, match=r"invalid configuration argument \(9\)"):
        kf.launch(_FailingLib(), q, k, v, True, 4, 0, 0)
