"""Port: Mamba's selective scan (``repro_torch.kernels.mamba_scan``).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds both of its
entries against their plain versions there). Here the contract entry's
plain version, and the wrapper's CPU route, are held to the Pallas kernel
in interpret mode at ``tests/test_kernels.py``'s shapes and to the
sequential recurrence ``mamba_ref`` in float64 from a nonzero h0, at
decode's S = 1 and at a ragged S and E (which the Pallas kernel's
divisibility asserts refuse); the model entry's plain version (the JAX
model's chunked scan) is held to the JAX model's own scan and to the
contract on da and dbu formed from the same delta, u, B and A; the
wrappers' contracts are tested.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mamba_scan as km
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_ref

#: tests/test_kernels.py's bound for the Pallas kernel against ``mamba_ref``
#: (float32 sums in another order)
TOL = dict(atol=1e-5, rtol=1e-5)


def _contract(B, S, E, N, *, nonzero_h0, seed):
    """tests/test_kernels.py's inputs from a seed: da = exp(-|N(0, 1)|),
    dbu = 0.1 N(0, 1), c ~ N(0, 1); h0 ~ N(0, 1) or zeros."""
    rng = np.random.default_rng(seed)
    da = np.exp(-np.abs(rng.normal(size=(B, S, E, N)))).astype(np.float32)
    dbu = (0.1 * rng.normal(size=(B, S, E, N))).astype(np.float32)
    c = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = (rng.normal(size=(B, E, N)) if nonzero_h0 else np.zeros((B, E, N))).astype(np.float32)
    return da, dbu, c, h0


def _model(B, S, E, N, *, dtype, seed):
    """The model entry's inputs: delta = softplus(N(0, 1)), u ~ N(0, 1) and
    B, C as strided views of one [B, S, 3 + 2N] projection in ``dtype``,
    A = -exp(0.5 N(0, 1)), h0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    delta = torch.nn.functional.softplus(torch.from_numpy(rng.normal(size=(B, S, E)))).float()
    u = torch.from_numpy(rng.normal(size=(B, S, E)).astype(np.float32)).to(dt)
    xdbc = torch.from_numpy(rng.normal(size=(B, S, 3 + 2 * N)).astype(np.float32)).to(dt)
    A = -torch.from_numpy(np.exp(0.5 * rng.normal(size=(E, N))).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(B, E, N)).astype(np.float32))
    return delta, u, xdbc[..., 3:3 + N], xdbc[..., 3 + N:], A, h0


def _ref64(da, dbu, c, h0):
    y, hT = mamba_ref(*(torch.from_numpy(np.asarray(a, np.float64)) for a in (da, dbu, c, h0)))
    return y.numpy(), hT.numpy()


@pytest.mark.parametrize("B,S,E,N,chunk,eblock", [(1, 32, 16, 4, 8, 8), (2, 64, 32, 8, 16, 16)])
def test_plain_matches_pallas_interpret(B, S, E, N, chunk, eblock):
    """tests/test_kernels.py:83's sweep: the plain version and the CPU route
    against the Pallas kernel in interpret mode and JAX's ``mamba_ref``."""
    da, dbu, c, h0 = _contract(B, S, E, N, nonzero_h0=False, seed=B * 100 + S)
    jy, jh = jops.mamba_ssm_scan(*(jnp.asarray(a) for a in (da, dbu, c, h0)), chunk=chunk,
                                 eblock=eblock, mode="interpret")
    ry, rh = jref.mamba_ref(jnp.asarray(da), jnp.asarray(dbu), jnp.asarray(c))
    km.reset_launches()
    for fn in (km.mamba_scan_torch, km.mamba_scan):
        y, hT = fn(*(torch.from_numpy(a) for a in (da, dbu, c, h0)))
        assert y.dtype == hT.dtype == torch.float32
        assert tuple(y.shape) == (B, S, E) and tuple(hT.shape) == (B, E, N)
        for want_y, want_h in ((jy, jh), (ry, rh)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
            np.testing.assert_allclose(hT.numpy(), np.asarray(want_h), **TOL)
    assert not km.LAUNCHES  # the CPU route never launches the kernel


@pytest.mark.parametrize("B,S,E,N", [(2, 1, 16, 4), (2, 33, 96, 16), (1, 17, 40, 8),
                                     (3, 5, 7, 4)])
def test_plain_matches_float64_from_nonzero_state(B, S, E, N):
    """A nonzero h0, decode's S = 1, and a ragged S and E (the Pallas
    kernel asserts S % chunk == 0 and E % eblock == 0) against the float64
    recurrence."""
    arrs = _contract(B, S, E, N, nonzero_h0=True, seed=S * 31 + E)
    want_y, want_h = _ref64(*arrs)
    y, hT = ops.mamba_ssm_scan(*(torch.from_numpy(a) for a in arrs), mode="torch")
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(hT.numpy(), want_h, **TOL)


def test_decode_steps_chain_to_the_prefill():
    """Scanning S tokens at once equals S scans of one token each, every one
    starting from the state the last returned (the serving decode loop)."""
    delta, u, bm, cm, A, h0 = _model(2, 9, 24, 8, dtype="float32", seed=3)
    y_all, h_all = km.mamba_selective_scan(delta, u, bm, cm, A, h0)
    h, ys = h0, []
    for t in range(9):
        sl = slice(t, t + 1)
        y, h = km.mamba_selective_scan(delta[:, sl].contiguous(), u[:, sl].contiguous(),
                                       bm[:, sl], cm[:, sl], A, h)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_all.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h_all.numpy(), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 33, 512])
def test_model_entry_matches_contract_and_float64(S, dtype):
    """The model entry's plain version (chunks of 256 when they divide S)
    against the contract's on da = exp(delta A) and dbu = (delta u) B formed
    from the same inputs, and against the float64 recurrence on the same
    products in float64."""
    delta, u, bm, cm, A, h0 = _model(2, S, 24, 4, dtype=dtype, seed=S)
    y, hT = ops.selective_scan(delta, u, bm, cm, A, h0, mode="torch")
    assert y.dtype == hT.dtype == torch.float32 and tuple(y.shape) == (2, S, 24)
    da = torch.exp(delta[..., None] * A)
    dbu = (delta * u.float())[..., None] * bm.float()[:, :, None, :]
    cy, ch = km.mamba_scan(da, dbu, cm.float().contiguous(), h0)
    np.testing.assert_allclose(y.numpy(), cy.numpy(), **TOL)
    np.testing.assert_allclose(hT.numpy(), ch.numpy(), **TOL)
    d64 = delta.double()
    ry, rh = mamba_ref(torch.exp(d64[..., None] * A.double()),
                       (d64 * u.double())[..., None] * bm.double()[:, :, None, :],
                       cm.double(), h0.double())
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **TOL)
    np.testing.assert_allclose(hT.numpy(), rh.numpy(), **TOL)


def test_model_entry_matches_the_jax_model_scan():
    """The model entry's plain version is the JAX model's chunked scan: the
    JAX Mamba block's scan, rebuilt from ``repro/models/mamba.py:102-123``
    on the same inputs (two chunks of 256 at S = 512), agrees within 1e-5."""
    import jax

    B, S, E, N = 1, 512, 16, 4
    delta, u, bm, cm, A, h0 = _model(B, S, E, N, dtype="float32", seed=11)
    j = {k: jnp.asarray(x.numpy()) for k, x in
         dict(delta=delta, u=u, b=bm.contiguous(), c=cm.contiguous(), A=A, h0=h0).items()}
    c = 256
    n = S // c

    def chunk_body(h, xs):
        d_c, u_c, b_c, c_c = xs
        da_c = jnp.exp(d_c[..., None] * j["A"][None, None])
        dbu_c = (d_c * u_c)[..., None] * b_c[:, :, None, :]

        def step(hh, t):
            hh = da_c[:, t] * hh + dbu_c[:, t]
            return hh, jnp.einsum("ben,bn->be", hh, c_c[:, t])

        return jax.lax.scan(step, h, jnp.arange(c))

    split = lambda x: x.reshape(B, n, c, *x.shape[2:]).transpose(  # noqa: E731
        1, 0, 2, *range(3, x.ndim + 1))
    hT, ys = jax.lax.scan(chunk_body, j["h0"], (split(j["delta"]), split(j["u"]),
                                                split(j["b"]), split(j["c"])))
    want_y = np.asarray(ys).reshape(n, c, B, E).transpose(2, 0, 1, 3).reshape(B, S, E)
    y, h = km.mamba_selective_scan_torch(delta, u, bm, cm, A, h0)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hT), **TOL)


def test_strided_b_and_c_read_in_place():
    """B and C as views of one projection (strided, last dim contiguous)
    give what their contiguous copies give."""
    delta, u, bm, cm, A, h0 = _model(2, 6, 10, 8, dtype="bfloat16", seed=5)
    assert not bm.is_contiguous() and not cm.is_contiguous()
    got = km.mamba_selective_scan(delta, u, bm, cm, A, h0)
    want = km.mamba_selective_scan(delta, u, bm.contiguous(), cm.contiguous(), A, h0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_contract():
    da, dbu, c, h0 = (torch.from_numpy(a) for a in _contract(1, 3, 8, 4, nonzero_h0=True,
                                                               seed=1))
    margs = _model(1, 3, 8, 4, dtype="float32", seed=1)
    km.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        ops.mamba_ssm_scan(da, dbu, c, h0, mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.selective_scan(*margs, mode="cuda")
    with pytest.raises(ValueError, match="cuda\\|torch"):
        ops.mamba_ssm_scan(da, dbu, c, h0, mode="interpret")
    with pytest.raises(ValueError, match="cuda\\|torch"):
        ops.selective_scan(*margs, mode="interpret")
    with pytest.raises(ValueError, match="N in"):
        x = torch.zeros(1, 3, 8, 5)
        km.mamba_scan(x, x, torch.zeros(1, 3, 5), torch.zeros(1, 8, 5))
    with pytest.raises(TypeError, match="da must be float32"):
        km.mamba_scan(da.double(), dbu, c, h0)
    with pytest.raises(TypeError, match="h0 must be float32"):
        km.mamba_scan(da, dbu, c, h0.bfloat16())
    with pytest.raises(ValueError, match="does not match"):
        km.mamba_scan(da, dbu[:, :2], c, h0)
    with pytest.raises(ValueError, match="h0 "):
        km.mamba_scan(da, dbu, c, h0[:, :4])
    with pytest.raises(ValueError, match="empty"):
        km.mamba_scan(da[:, :0], dbu[:, :0], c[:, :0], h0)
    with pytest.raises(ValueError, match="contiguous"):
        km.mamba_scan(da.transpose(2, 3).contiguous().transpose(2, 3), dbu, c, h0)
    with pytest.raises(ValueError, match="B <= 65535"):
        km.mamba_scan(*(x.expand(65536, *x.shape[1:]) for x in (da, dbu, c)),
                      h0.expand(65536, 8, 4).contiguous())
    delta, u, bm, cm, A, h = margs
    with pytest.raises(TypeError, match="one dtype"):
        km.mamba_selective_scan(delta, u.bfloat16(), bm, cm, A, h)
    with pytest.raises(TypeError, match="delta must be float32"):
        km.mamba_selective_scan(delta.bfloat16(), u, bm, cm, A, h)
    with pytest.raises(ValueError, match="A "):
        km.mamba_selective_scan(delta, u, bm, cm, A[:4], h)
    with pytest.raises(ValueError, match="u must be contiguous"):
        km.mamba_selective_scan(delta, torch.zeros(1, 3, 16)[..., ::2], bm, cm, A, h)
    # meta tensors (the dry run): the outputs' shapes, no launch
    y, hT = km.mamba_scan(*(x.to("meta") for x in (da, dbu, c, h0)))
    assert y.is_meta and y.shape == da.shape[:3] and hT.shape == h0.shape
    y, hT = km.mamba_selective_scan(*(x.to("meta") for x in margs))
    assert y.is_meta and y.shape == margs[0].shape and hT.shape == margs[-1].shape
    assert not km.LAUNCHES  # the CPU route never launches the kernel


def _c_signature(name: str) -> list:
    """The parameter types of ``extern "C" int <name>(...)`` in
    csrc/mamba_scan.cu, as ctypes types."""
    import ctypes
    import pathlib
    import re

    src = (pathlib.Path(km.__file__).parent / "csrc" / "mamba_scan.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong}
    out = []
    for p in params.split(","):
        words = p.replace("const", "").replace("*", " * ").split()[:-1]  # drop the name
        out.append(kinds[" ".join(words).replace(" *", "*")])
    return out


class _FakeFn:
    """One launcher of ``_FakeLib``: records its arguments, takes the
    ``argtypes`` and ``restype`` that ``km.bind`` declares."""

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
        self.mamba_scan_launch = _FakeFn(self.calls, "contract", ret)
        self.mamba_selective_scan_launch = _FakeFn(self.calls, "model", ret)
        self.mamba_scan_error_string = lambda err: b"invalid configuration argument"


@pytest.mark.parametrize("B,S,E,N,dtype", [(2, 33, 96, 16, "bfloat16"), (1, 1, 40, 8, "float32"),
                                           (3, 5, 7, 4, "bfloat16")])
def test_launch_passes_each_entry_its_arguments(B, S, E, N, dtype):
    """Each entry gets as many arguments as its C signature, of the types it
    declares: the input and output pointers, the shape, and B's and C's
    batch/sequence strides read in place (strided views of one
    projection)."""
    margs = _model(B, S, E, N, dtype=dtype, seed=2)
    delta, u, bm, cm, A, h0 = margs
    da = torch.exp(delta[..., None] * A)
    dbu = (delta * u.float())[..., None] * bm.float()[:, :, None, :]
    cargs = (da, dbu, cm.float(), h0)
    lib = km.bind(_FakeLib())
    for entry, inputs, c_name in (("contract", cargs, "mamba_scan_launch"),
                                  ("model", margs, "mamba_selective_scan_launch")):
        lib.calls.clear()
        y, hT = km.launch(lib, entry, inputs, 5)
        assert y.shape == (B, S, E) and hT.shape == (B, E, N)
        assert y.dtype == hT.dtype == torch.float32
        (fn, args), = lib.calls
        assert fn == entry
        assert getattr(lib, c_name).argtypes == _c_signature(c_name)
        assert len(args) == len(_c_signature(c_name))
        n_in = len(inputs)
        assert args[:n_in + 2] == (*(x.data_ptr() for x in inputs), y.data_ptr(), hT.data_ptr())
        if entry == "contract":
            assert args[n_in + 2:] == (B, S, E, N, *inputs[2].stride()[:2], 5)
        else:
            assert args[n_in + 2:] == (int(dtype == "bfloat16"), B, S, E, N, *bm.stride()[:2],
                                       *cm.stride()[:2], 5)


@pytest.mark.parametrize("entry", ["contract", "model"])
def test_launch_raises_on_a_launcher_error(entry):
    """No entry's failure passes silently: the code and its message raise."""
    margs = _model(1, 4, 8, 4, dtype="float32", seed=6)
    delta, u, bm, cm, A, h0 = margs
    inputs = margs if entry == "model" else (
        torch.exp(delta[..., None] * A), (delta * u)[..., None] * bm[:, :, None, :],
        cm.contiguous(), h0)
    with pytest.raises(RuntimeError, match=r"invalid configuration argument \(9\)"):
        km.launch(km.bind(_FakeLib(ret=9)), entry, inputs, 0)


def test_states_need_16_byte_alignment():
    """Each thread moves four states as one 16-byte access: an h0 or A that
    starts 4 bytes into its storage is refused."""
    delta, u, bm, cm, A, h0 = _model(1, 3, 8, 4, dtype="float32", seed=7)
    h_off = torch.zeros(h0.numel() + 1)[1:].view(h0.shape).copy_(h0)
    a_off = torch.zeros(A.numel() + 1)[1:].view(A.shape).copy_(A)
    with pytest.raises(ValueError, match="h0 must be contiguous and 16-byte aligned"):
        km.mamba_selective_scan(delta, u, bm, cm, A, h_off)
    with pytest.raises(ValueError, match="A must be 16-byte aligned"):
        km.mamba_selective_scan(delta, u, bm, cm, a_off, h0)
