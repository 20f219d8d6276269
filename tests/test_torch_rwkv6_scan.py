"""Port: the WKV6 scan (``repro_torch.kernels.rwkv6_scan``).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there). Here the plain version, and the wrapper's CPU
route, are held to the JAX model's chunked WKV (``repro/models/rwkv.py::
wkv_chunked``), to the Pallas kernel in interpret mode (at a chunk that
divides S, which it asserts) and to the sequential recurrence
``rwkv6_ref`` in float64, at ragged S, decode's S = 1, a zero and a
nonzero initial state, bf16 and float32 r/k/v and a decay drawn per
channel and token; the wrapper's contract is tested.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import rwkv as JR
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as ks
from repro_torch.kernels.ref import rwkv6_ref

#: against the JAX model's chunked form, the same arithmetic in another
#: summation order: max |diff| within 1e-5 of the output's max |.|
CHUNKED_TOL = 1e-5
#: against the Pallas kernel and the float64 recurrence: tests/test_kernels.py's
#: bounds for the Pallas kernel (float32 sums over up to 64 tokens' decays)
TOL = dict(atol=5e-4, rtol=1e-3)

SEQS = [1, 2, 17, 32, 33, 64]


def _inputs(B, S, H, dh, *, nonzero_s0, dtype, seed):
    """Seeded numpy inputs in the model layout, r/k/v rounded to ``dtype``
    (so every route reads the same values), wlog = -exp(0.5 N(0, 1)) per
    channel and token."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32) for _ in range(3))
    if dtype == "bfloat16":
        r, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (r, k, v))
    wlog = -np.exp(0.5 * rng.normal(size=(B, S, H, dh))).astype(np.float32)
    u = (0.1 * rng.normal(size=(H, dh))).astype(np.float32)
    s0 = (rng.normal(size=(B, H, dh, dh)) if nonzero_s0
          else np.zeros((B, H, dh, dh))).astype(np.float32)
    return r, k, v, wlog, u, s0


def _port(arrs, dtype):
    r, k, v, wlog, u, s0 = (torch.from_numpy(a) for a in arrs)
    dt = getattr(torch, dtype)
    return r.to(dt), k.to(dt), v.to(dt), wlog, u, s0


def _jax(arrs, dtype):
    r, k, v, wlog, u, s0 = (jnp.asarray(a) for a in arrs)
    dt = getattr(jnp, dtype)
    return r.astype(dt), k.astype(dt), v.astype(dt), wlog, u, s0


def _ref64(arrs):
    """``rwkv6_ref`` in float64 on the [B * H, S, dh] fold, back in the
    model layout."""
    r, k, v, wlog, u, s0 = (torch.from_numpy(a).double() for a in arrs)
    B, S, H, dh = r.shape
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(B * H, S, dh)  # noqa: E731
    y, sT = rwkv6_ref(fold(r), fold(k), fold(v), fold(wlog), u.repeat(B, 1),
                      s0.reshape(B * H, dh, dh))
    return y.reshape(B, H, S, dh).permute(0, 2, 1, 3).numpy(), sT.reshape(B, H, dh, dh).numpy()


def _close_to_scale(got, want, tol):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"max |diff| {err:.3g} over scale {scale:.3g}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nonzero_s0", [False, True])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("S", SEQS)
def test_plain_matches_jax_chunked(S, dh, nonzero_s0, dtype):
    arrs = _inputs(2, S, 2, dh, nonzero_s0=nonzero_s0, dtype=dtype, seed=S * 7 + dh)
    jy, js = JR.wkv_chunked(*_jax(arrs, dtype))
    for fn in (ks.rwkv6_scan_torch, ks.rwkv6_scan):  # the plain version and the CPU route
        y, sT = fn(*_port(arrs, dtype))
        assert y.dtype == sT.dtype == torch.float32
        assert tuple(y.shape) == (2, S, 2, dh) and tuple(sT.shape) == (2, 2, dh, dh)
        _close_to_scale(y.numpy(), np.asarray(jy, np.float64), CHUNKED_TOL)
        _close_to_scale(sT.numpy(), np.asarray(js, np.float64), CHUNKED_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nonzero_s0", [False, True])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("S", SEQS)
def test_plain_matches_float64_recurrence(S, dh, nonzero_s0, dtype):
    arrs = _inputs(2, S, 2, dh, nonzero_s0=nonzero_s0, dtype=dtype, seed=S * 11 + dh)
    want_y, want_s = _ref64(arrs)
    y, sT = ops.rwkv6_wkv(*_port(arrs, dtype), mode="torch")
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(sT.numpy(), want_s, **TOL)


#: the Pallas kernel asserts S % chunk == 0: a chunk dividing each S
PALLAS_CHUNK = {1: 1, 2: 2, 17: 17, 32: 32, 33: 11, 64: 32}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("S", SEQS)
def test_plain_matches_pallas_interpret(S, dh, dtype):
    arrs = _inputs(1, S, 2, dh, nonzero_s0=True, dtype=dtype, seed=S * 13 + dh)
    jy, js = jops.rwkv6_wkv(*_jax(arrs, dtype), chunk=PALLAS_CHUNK[S], mode="interpret")
    y, sT = ks.rwkv6_scan_torch(*_port(arrs, dtype))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(sT.numpy(), np.asarray(js), **TOL)


def test_decode_steps_chain_to_the_prefill():
    """Scanning S tokens at once equals S scans of one token each, every one
    starting from the state the last returned (the serving decode loop)."""
    arrs = _inputs(2, 9, 4, 16, nonzero_s0=True, dtype="float32", seed=5)
    r, k, v, wlog, u, s0 = _port(arrs, "float32")
    y_all, s_all = ks.rwkv6_scan(r, k, v, wlog, u, s0)
    s, ys = s0, []
    for t in range(9):
        y, s = ks.rwkv6_scan(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], wlog[:, t:t + 1], u, s)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_all.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), s_all.numpy(), **TOL)


def test_strided_inputs_read_in_place():
    """r, k, v as views of one fused projection [B, S, 3, H, dh] (strided,
    last dim contiguous) give what their contiguous copies give."""
    rng = np.random.default_rng(8)
    B, S, H, dh = 2, 5, 3, 16
    fused = torch.from_numpy(rng.normal(size=(B, S, 3, H, dh)).astype(np.float32))
    r, k, v = fused.unbind(2)
    wlog = -torch.from_numpy(np.exp(rng.normal(size=(B, S, H, dh))).astype(np.float32))
    u = torch.zeros(H, dh)
    s0 = torch.from_numpy(rng.normal(size=(B, H, dh, dh)).astype(np.float32))
    assert not r.is_contiguous()
    got = ks.rwkv6_scan(r, k, v, wlog, u, s0)
    want = ks.rwkv6_scan(r.contiguous(), k.contiguous(), v.contiguous(), wlog, u, s0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_contract():
    arrs = _inputs(1, 3, 2, 16, nonzero_s0=True, dtype="float32", seed=1)
    r, k, v, wlog, u, s0 = _port(arrs, "float32")
    ks.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        ops.rwkv6_wkv(r, k, v, wlog, u, s0, mode="cuda")
    with pytest.raises(ValueError, match="cuda\\|torch"):
        ops.rwkv6_wkv(r, k, v, wlog, u, s0, mode="interpret")
    with pytest.raises(ValueError, match="dh in"):
        x = torch.zeros(1, 3, 1, 32)
        ks.rwkv6_scan(x, x, x, x, torch.zeros(1, 32), torch.zeros(1, 1, 32, 32))
    with pytest.raises(TypeError, match="float32 or bf16"):
        ks.rwkv6_scan(r.half(), k.half(), v.half(), wlog, u, s0)
    with pytest.raises(TypeError, match="one dtype"):
        ks.rwkv6_scan(r.bfloat16(), k, v, wlog, u, s0)
    with pytest.raises(TypeError, match="wlog must be float32"):
        ks.rwkv6_scan(r, k, v, wlog.double(), u, s0)
    with pytest.raises(TypeError, match="s0 must be float32"):
        ks.rwkv6_scan(r, k, v, wlog, u, s0.bfloat16())
    with pytest.raises(ValueError, match="empty"):
        ks.rwkv6_scan(r[:, :0], k[:, :0], v[:, :0], wlog[:, :0], u, s0)
    with pytest.raises(ValueError, match="does not match"):
        ks.rwkv6_scan(r, k[:, :2], v, wlog, u, s0)
    with pytest.raises(ValueError, match="u "):
        ks.rwkv6_scan(r, k, v, wlog, u[:1], s0)
    with pytest.raises(ValueError, match="contiguous last dim"):
        ks.rwkv6_scan(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, wlog, u, s0)
    with pytest.raises(ValueError, match="s0 must be contiguous"):
        ks.rwkv6_scan(r, k, v, wlog, u, s0.transpose(2, 3))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ks.rwkv6_scan(r.to("meta"), k.to("meta"), v.to("meta"), wlog.to("meta"),
                      u.to("meta"), s0.to("meta"))
    assert not ks.LAUNCHES  # the CPU route never launches the kernel


@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("S", [1, 2, 17, 64])
def test_plain_matches_float64_under_strong_decays(S, dh):
    """The plain version, the card's yardstick for the chunked entry, holds
    to the float64 recurrence where decays are strongest: wlog = -exp(U[-6,
    2]), down to -e^2 per token, so a chunk's cumulative log decay passes
    -88 within a few dozen tokens (a factorisation relative to the chunk's
    first token would overflow float32 here)."""
    arrs = list(_inputs(2, S, 2, dh, nonzero_s0=True, dtype="bfloat16", seed=S * 17 + dh))
    rng = np.random.default_rng(S + dh)
    arrs[3] = -np.exp(rng.uniform(-6.0, 2.0, size=arrs[3].shape)).astype(np.float32)
    want_y, want_s = _ref64(arrs)
    y, sT = ks.rwkv6_scan_torch(*_port(arrs, "bfloat16"))
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(sT.numpy(), want_s, **TOL)


@pytest.mark.parametrize("dtype,S,want", [
    (torch.bfloat16, 512, "chunked"), (torch.bfloat16, 2, "chunked"),
    (torch.bfloat16, 1, "sequential"), (torch.float32, 512, "sequential"),
    (torch.float32, 1, "sequential"),
])
def test_entry_by_dtype_and_length(dtype, S, want):
    """bf16 prefill on the tensor cores; float32 and every decode step on
    the CUDA cores."""
    assert want in ks.ENTRIES
    assert ks.entry(dtype, S) == want


def _c_signature(name: str) -> list:
    """The parameter types of ``extern "C" int <name>(...)`` in
    csrc/rwkv6_scan.cu, as ctypes types."""
    import ctypes
    import pathlib
    import re

    src = (pathlib.Path(ks.__file__).parent / "csrc" / "rwkv6_scan.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong}
    out = []
    for p in params.split(","):
        words = p.replace("const", "").replace("*", " * ").split()[:-1]  # drop the name
        out.append(kinds[" ".join(words).replace(" *", "*")])
    return out


class _FakeFn:
    """One launcher of ``_FakeLib``: records its arguments, takes the
    ``argtypes`` and ``restype`` that ``ks.bind`` declares."""

    def __init__(self, calls, name, ret=0):
        self.calls, self.name, self.ret = calls, name, ret

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return self.ret


class _FakeLib:
    """Records the launchers' arguments in place of the built library;
    ``ret`` is what every launcher returns (a CUDA error code, or 0)."""

    def __init__(self, ret=0):
        self.calls = []
        self.rwkv6_scan_launch = _FakeFn(self.calls, "sequential", ret)
        self.rwkv6_scan_chunked_launch = _FakeFn(self.calls, "chunked", ret)
        self.rwkv6_scan_error_string = lambda err: b"invalid configuration argument"


@pytest.mark.parametrize("B,S,H,dh,dtype,fused", [
    (2, 40, 3, 64, "bfloat16", False), (2, 40, 3, 64, "bfloat16", True),
    (1, 2, 2, 16, "bfloat16", True), (2, 1, 3, 64, "bfloat16", False),
    (2, 17, 2, 16, "float32", True), (1, 1, 2, 16, "float32", False),
])
def test_launch_passes_each_entry_its_arguments(B, S, H, dh, dtype, fused):
    """Each entry gets as many arguments as its C signature, of the types it
    declares: the input and output pointers, the shape and every input's
    batch/sequence/head strides, read in place (r, k, v as views of one
    fused projection when ``fused``)."""
    arrs = _inputs(B, S, H, dh, nonzero_s0=True, dtype=dtype, seed=4)
    r, k, v, wlog, u, s0 = _port(arrs, dtype)
    if fused:
        r, k, v = torch.stack([r, k, v], dim=2).unbind(2)  # [B, S, 3, H, dh] views
        assert not r.is_contiguous()
    lib = ks.bind(_FakeLib())
    name, y, sT = ks.launch(lib, r, k, v, wlog, u, s0, 7)
    assert name == ks.entry(r.dtype, S)
    assert y.shape == (B, S, H, dh) and sT.shape == (B, H, dh, dh)
    assert y.dtype == sT.dtype == torch.float32
    (fn, args), = lib.calls
    assert fn == name
    launcher = lib.rwkv6_scan_chunked_launch if fn == "chunked" else lib.rwkv6_scan_launch
    c_name = "rwkv6_scan_chunked_launch" if fn == "chunked" else "rwkv6_scan_launch"
    assert launcher.argtypes == _c_signature(c_name)
    assert len(args) == len(launcher.argtypes)
    assert args[:8] == tuple(x.data_ptr() for x in (r, k, v, wlog, u, s0, y, sT))
    rest = args[8:] if fn == "chunked" else args[9:]
    if fn == "sequential":
        assert args[8] == int(r.dtype == torch.bfloat16)
    assert rest[:4] == (dh, B, S, H)
    assert rest[4:16] == (*r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                          *wlog.stride()[:3])
    assert rest[16] == 7  # the stream


@pytest.mark.parametrize("dtype,S", [("bfloat16", 33), ("bfloat16", 1), ("float32", 33)])
def test_launch_raises_on_a_launcher_error(dtype, S):
    """No entry's failure passes silently: the code and its message raise."""
    args = _port(_inputs(1, S, 2, 16, nonzero_s0=True, dtype=dtype, seed=3), dtype)
    with pytest.raises(RuntimeError, match=r"invalid configuration argument \(9\)"):
        ks.launch(ks.bind(_FakeLib(ret=9)), *args, 0)


def test_chunked_entry_needs_aligned_rows():
    """The chunked entry copies rows in 16-byte pieces: a head stride of 17
    bf16 is refused; the same view in float32 (the sequential entry) and a
    decode step (S = 1) are taken."""
    arrs = _inputs(1, 3, 2, 16, nonzero_s0=True, dtype="bfloat16", seed=2)
    r, k, v, wlog, u, s0 = _port(arrs, "bfloat16")
    odd = torch.zeros(1, 3, 2, 17, dtype=torch.bfloat16)[..., :16]
    odd.copy_(r)
    with pytest.raises(ValueError, match="16-byte row loads"):
        ks.rwkv6_scan(odd, k, v, wlog, u, s0)
    ks.rwkv6_scan(odd.float(), k.float(), v.float(), wlog, u, s0)
    ks.rwkv6_scan(odd[:, :1], k[:, :1], v[:, :1], wlog[:, :1], u, s0)
