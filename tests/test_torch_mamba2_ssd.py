"""The plain versions of kernel B5 (``kernels/mamba2_ssd/ref.py``) and its
wrapper ``ops.ssd`` against the JAX kernel ``ssd_pallas`` (through its
``ops.ssd``, interpret mode, as ``tests/test_kernels.py`` runs it), the
JAX oracle ``ssd_ref`` and ``jax.grad`` of the JAX model's chunked twin.

Inputs are drawn with numpy from a seed and cross to both frameworks as
numpy arrays: the cases of ``tests/test_kernels.py``'s SSD sweep (with
an odd chunk count and chunk == S), the mamba2-2.7b smoke width (P=32,
N=16), and a strong decay whose cumsum passes -100 inside one chunk
(where ``exp(-cum)`` would overflow f32 if the decay were factorised),
each in f32 and bf16, with and without an initial state.

Tolerances: both sides compute in f32, in other summation orders, so in
f32 y and the state agree within 1e-5 of their largest magnitude
(measured: at most 4.4e-6 and 3.5e-6); against the sequential oracle
the chunked form is held to the JAX test's own rtol 2e-3 / atol 2e-4.
With bf16 inputs the state stays f32 (the same 1e-5) and y rounds once
to bf16 on both sides, so each element is held to one bf16 ulp of
itself (2^-7 of its magnitude; measured: every element equal) — an f32
result near a rounding boundary may round the other way.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _tf32x3 import WKV_TOL, mm, within_wkv_tol
from repro.kernels.mamba2_ssd.ops import ssd as jax_ssd
from repro.kernels.mamba2_ssd.ref import ssd_ref
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.mamba2_ssd import ops
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref
from repro_torch.kernels.mamba2_ssd.ref import ssd_ref as port_ssd_ref

CASES = [                       # (B, S, H, P, N, chunk, strong decay)
    (1, 32, 2, 8, 8, 8, False),
    (2, 64, 4, 16, 8, 16, False),
    (1, 64, 1, 8, 16, 64, False),   # chunk == S
    (2, 40, 2, 8, 8, 8, False),     # odd chunk count
    (2, 64, 4, 32, 16, 64, False),  # mamba2-2.7b smoke width
    (1, 64, 2, 8, 8, 32, True),     # cum passes -100 inside a chunk
]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("x", "dt", "A", "Bs", "Cs")
# The JAX oracle, compiled once per shape and dtype.
jax_ssd_ref = jax.jit(ssd_ref)


def _case(B, S, H, P, N, strong, with_state, seed=0):
    r = np.random.default_rng(seed)
    mk = lambda *s, sc=0.5: (r.normal(size=s) * sc).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(B, S, H))))
    if strong:
        dt = 4.0 * dt + 1.0
    return {"x": mk(B, S, H, P), "dt": dt.astype(np.float32),
            "A": (-np.exp(r.normal(size=H) * 0.3)).astype(np.float32),
            "Bs": mk(B, S, N), "Cs": mk(B, S, N),
            "s0": mk(B, H, P, N, sc=0.2) if with_state else None}


def _torch(x, dt):
    return {n: None if a is None else
            torch.tensor(a).to(torch.float32 if n == "s0" else dt)
            for n, a in x.items()}


def _jax(x, jdt):
    return [jnp.asarray(x[n]).astype(jdt) for n in NAMES]


def _close(got_y, got_s, want_y, want_s, kind):
    got_y = got_y.float().numpy() if torch.is_tensor(got_y) else got_y
    got_s = got_s.numpy() if torch.is_tensor(got_s) else got_s
    assert got_s.dtype == np.float32
    es = np.abs(got_s - want_s).max()
    assert es <= 1e-5 * np.abs(want_s).max(), es
    ey = np.abs(got_y - want_y)
    if kind == "f32":
        assert ey.max() <= 1e-5 * np.abs(want_y).max(), ey.max()
    else:
        assert (ey <= 2.0 ** -7 * np.abs(want_y)).all(), ey.max()


def test_the_strong_decay_case_passes_minus_100_inside_a_chunk():
    B, S, H, P, N, chunk, strong = CASES[-1]
    x = _case(B, S, H, P, N, strong, False)
    cum = np.cumsum((x["dt"] * x["A"]).reshape(B, S // chunk, chunk, H), 2)
    assert cum.min() < -100


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_chunked_plain_matches_jax_kernel(case, kind, state):
    B, S, H, P, N, chunk, strong = case
    jdt, tdt = DTYPES[kind]
    x = _case(B, S, H, P, N, strong, state, seed=sum(case[:6]))
    t = _torch(x, tdt)
    y, sf = ssd_chunked_ref(*(t[n] for n in NAMES), init_state=t["s0"],
                            chunk=chunk)
    assert y.dtype == tdt and y.shape == (B, S, H, P)
    s0 = None if x["s0"] is None else jnp.asarray(x["s0"])
    jy, js = jax_ssd(*_jax(x, jdt), init_state=s0, chunk=chunk,
                     interpret=True)
    _close(y, sf, np.asarray(jy.astype(jnp.float32)), np.asarray(js), kind)
    if kind == "f32":
        oy, os_ = jax_ssd_ref(*_jax(x, jdt), jnp.zeros((B, H, P, N))
                              if s0 is None else s0)
        np.testing.assert_allclose(y.numpy(), np.asarray(oy), rtol=2e-3,
                                   atol=2e-4)
        np.testing.assert_allclose(sf.numpy(), np.asarray(os_), rtol=2e-3,
                                   atol=2e-4)


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_sequential_plain_matches_jax_oracle(case, kind, state):
    B, S, H, P, N, _, strong = case
    jdt, tdt = DTYPES[kind]
    x = _case(B, S, H, P, N, strong, state, seed=sum(case[:6]))
    s0 = (np.zeros((B, H, P, N), np.float32) if x["s0"] is None
          else x["s0"])
    jy, js = jax_ssd_ref(*_jax(x, jdt), jnp.asarray(s0))
    t = _torch(x, tdt)
    y, sf = port_ssd_ref(*(t[n] for n in NAMES), torch.tensor(s0))
    _close(y, sf, np.asarray(jy.astype(jnp.float32)), np.asarray(js), kind)


@pytest.mark.parametrize("case", CASES)
def test_wrapper_on_the_cpu_is_the_plain_version(case):
    """On CPU tensors ``ops.ssd`` runs ``ssd_chunked_ref`` (bit for bit)
    and counts no kernel launch; chunk > S means chunk = S."""
    B, S, H, P, N, chunk, strong = case
    t = _torch(_case(B, S, H, P, N, strong, True, seed=3), torch.float32)
    ins = [t[n] for n in NAMES]
    before = ops.ssd.launches
    y, sf = ops.ssd(*ins, init_state=t["s0"], chunk=chunk)
    want = ssd_chunked_ref(*ins, init_state=t["s0"], chunk=chunk)
    assert torch.equal(y, want[0]) and torch.equal(sf, want[1])
    assert ops.ssd.launches == before
    y2, _ = ops.ssd(*ins, chunk=4 * S)
    torch.testing.assert_close(
        y2, ssd_chunked_ref(*ins, chunk=S)[0], rtol=0, atol=0)


def _weights(B, S, H, P, N, seed=9):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, H, P)).astype(np.float32),
            r.normal(size=(B, H, P, N)).astype(np.float32))


@pytest.mark.parametrize("case,state", [
    ((2, 64, 4, 16, 8, 16, False), True),
    ((2, 40, 2, 8, 8, 8, False), False),
    ((1, 64, 2, 8, 8, 32, True), True),
])
def test_function_gradients_match_autograd_and_jax_grad(case, state):
    """The ``SSD`` Function's recomputed gradients equal autograd through
    the plain version, and ``jax.grad`` of the JAX model's chunked twin
    in f32 within 1e-4 of each gradient's scale; dA is summed over the
    batch and the sequence (A is shared), and ds0 is returned when a
    state was given.  Under the strong decay the twin's own gradient is
    NaN (it takes ``exp`` of the positive differences above the diagonal,
    which overflow to inf, and masks after: inf * 0 in the backward;
    ROADMAP C10), so there the port is held to ``jax.grad`` of the
    sequential oracle instead."""
    B, S, H, P, N, chunk, strong = case
    x = _case(B, S, H, P, N, strong, state, seed=21)
    wy, ws = _weights(B, S, H, P, N)
    names = list(NAMES) + (["s0"] if state else [])

    def port(fn):
        t = {n: torch.tensor(x[n]).requires_grad_() for n in names}
        y, sf = fn(*(t[n] for n in NAMES), init_state=t.get("s0"),
                   chunk=chunk)
        ((y * torch.tensor(wy)).sum()
         + (sf * torch.tensor(ws)).sum()).backward()
        return {n: t[n].grad for n in names}

    got = port(ops.ssd)
    plain = port(ssd_chunked_ref)
    for n in names:
        torch.testing.assert_close(got[n], plain[n], rtol=0, atol=0)
    assert got["A"].shape == (H,)

    def jloss(*args, oracle=False):
        if oracle:
            y, sf = jax_ssd_ref(*args[:5], args[5] if state
                                else jnp.zeros((B, H, P, N)))
        else:
            y, sf = jax_ssd_chunked(*args[:5], chunk=chunk,
                                    init_state=args[5] if state else None)
        return jnp.sum(y * wy) + jnp.sum(sf * ws)

    jin = [jnp.asarray(x[n]) for n in names]
    argnums = tuple(range(len(names)))
    jg = jax.grad(jloss, argnums=argnums)(*jin)
    if strong:
        assert not np.isfinite(np.asarray(jg[1])).all()
        jg = jax.grad(lambda *a: jloss(*a, oracle=True),
                      argnums=argnums)(*jin)
    for n, want in zip(names, jg):
        want = np.asarray(want)
        err = np.abs(got[n].numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (n, err)


def test_bf16_gradients_keep_the_input_dtypes():
    x = _case(1, 32, 2, 8, 8, False, True, seed=4)
    t = {n: torch.tensor(a).to(torch.float32 if n == "s0"
                               else torch.bfloat16).requires_grad_()
         for n, a in x.items()}
    y, sf = ops.ssd(*(t[n] for n in NAMES), init_state=t["s0"], chunk=8)
    (y.float().sum() + sf.sum()).backward()
    for n, a in t.items():
        assert a.grad.dtype == a.dtype and torch.isfinite(a.grad).all(), n


def _ops_args(B=1, S=16, H=2, P=8, N=8, dt=torch.float32):
    z = lambda *s: torch.zeros(s, dtype=dt)
    return [z(B, S, H, P), z(B, S, H), z(H), z(B, S, N), z(B, S, N)]


@pytest.mark.parametrize("arg,value,err", [
    (0, torch.zeros(1, 16, 8), ValueError),               # x not 4-D
    (1, torch.zeros(1, 16, 3), ValueError),               # dt's shape
    (2, torch.zeros(3), ValueError),                      # A's shape
    (3, torch.zeros(1, 16, 4), ValueError),               # Bs vs Cs
    (4, torch.zeros(1, 15, 8), ValueError),               # Cs's rows
    (1, torch.zeros(1, 16, 2, dtype=torch.bfloat16), TypeError),
    (2, torch.zeros(2, dtype=torch.bfloat16), TypeError),
    ("init_state", torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16),
     TypeError),
    ("init_state", torch.zeros(1, 2, 8, 4), ValueError),
    ("chunk", 6, ValueError),                             # 16 % 6
    ("chunk", 0, ValueError),
])
def test_rejects_what_the_kernel_does_not_take(arg, value, err):
    args, kw = _ops_args(), {}
    if isinstance(arg, int):
        args[arg] = value
    else:
        kw[arg] = value
    with pytest.raises(err):
        ops.ssd(*args, **kw)


def test_rejects_half_wide_heads_and_long_chunks():
    with pytest.raises(TypeError):
        ops.ssd(*_ops_args(dt=torch.float16))
    with pytest.raises(ValueError, match="P <= 64"):
        ops.ssd(*_ops_args(P=72))
    with pytest.raises(ValueError, match="N <= 128"):
        ops.ssd(*_ops_args(N=136))
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd(*_ops_args(S=1024), chunk=512)


def test_other_devices_raise_instead_of_falling_back():
    args = [t.to("meta") for t in _ops_args()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd(*args)


# ---------------------------------------------------------------------------
# The chunk body (csrc/mamba2_ssd_chunk.cu): its routing, and its
# arithmetic emulated in torch against the JAX kernel
# ---------------------------------------------------------------------------

def _ssd_chunk_emulated(x, dt, A, Bs, Cs, s0, chunk, products="tf32x3"):
    """The chunk body's arithmetic in torch, launch by launch: (1) cum
    summed row by row in f32, each chunk's own state (x dt exp(last -
    cum))^T B and exp(last); (2) the entering states, S tot + st; (3) C
    B^T, M = (C B^T) exp(cum_i - cum_j) dt_j below the diagonal, y = M x
    + exp(cum) (C S^T), rounded once."""
    B, S, H, P = x.shape
    N = Bs.shape[-1]
    Q, nc = chunk, S // chunk
    xc = x.float().reshape(B, nc, Q, H, P).transpose(2, 3)   # (B,nc,H,Q,P)
    dtc = dt.float().reshape(B, nc, Q, H).transpose(2, 3)    # (B,nc,H,Q)
    Bc = Bs.float().reshape(B, nc, 1, Q, N)
    Cc = Cs.float().reshape(B, nc, 1, Q, N)
    da = dtc * A.float()[:, None]
    cum = torch.empty_like(da)
    run = torch.zeros_like(da[..., 0])
    for i in range(Q):
        run = run + da[..., i]
        cum[..., i] = run
    last = cum[..., -1:]
    xw = xc * dtc[..., None] * torch.exp(last - cum)[..., None]
    st = mm(xw.transpose(-1, -2), Bc, products)             # (B,nc,H,P,N)
    tot = torch.exp(last[..., 0])
    state = (torch.zeros((B, H, P, N)) if s0 is None else s0.float())
    enter = []
    for c in range(nc):
        enter.append(state)
        state = state * tot[:, c, :, None, None] + st[:, c]
    enter = torch.stack(enter, 1)
    CB = mm(Cc, Bc.transpose(-1, -2), products)             # (B,nc,1,Q,Q)
    upper = torch.ones(Q, Q, dtype=torch.bool).triu(1)
    M = CB * torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        upper, float("-inf"))) * dtc[..., None, :]
    yo = mm(Cc, enter.transpose(-1, -2), products) * torch.exp(cum)[..., None]
    y = mm(M, xc, products) + yo
    return y.transpose(2, 3).reshape(B, S, H, P).to(x.dtype), state


EMULATED = [                     # (B, S, H, P, N, chunk, strong decay)
    (2, 64, 4, 32, 16, 64, False),     # mamba2-2.7b smoke width
    (1, 512, 2, 64, 128, 256, False),  # mamba2-2.7b's heads, two chunks
    (1, 512, 2, 64, 128, 256, True),   # cum passes -100 inside a chunk
]


@pytest.mark.parametrize("P,N,Q,want", [
    (64, 128, 256, "chunk_tf32x3"),   # mamba2-2.7b training
    (32, 16, 128, "chunk_tf32x3"),    # smoke width, chip_smoke phase 3e
    (32, 16, 64, "chunk_tf32x3"),     # smoke width, chunk 64
    (64, 128, 64, "chunk_tf32x3"),
    (20, 10, 40, "cuda_core"),        # P, N not multiples of 16
    (48, 128, 100, "cuda_core"),      # P 48, chunk not a multiple of 64
    (8, 8, 8, "cuda_core"),
    (16, 16, 64, "cuda_core"),        # P below one 32-row warp tile
    (64, 136, 256, "cuda_core"),      # N past 128
    (64, 128, 32, "cuda_core"),       # chunk below one 64-row tile
])
def test_body_routes_the_training_and_smoke_shapes_to_the_chunk_body(
        P, N, Q, want):
    """The router reads the widths alone: bf16 and f32 operands of one
    shape take the same body."""
    assert ops.body(P, N, Q) == want


def test_the_models_route_to_the_chunk_body():
    """mamba2-2.7b at its training shape (chunk 256 at seq 4096) and its
    smoke config at the CLI's smoke shape (seq 128, chunk 128)."""
    from repro_torch.configs import get_config, get_smoke

    for cfg, S in ((get_config("mamba2-2.7b"), 4096),
                   (get_smoke("mamba2-2.7b"), 128)):
        assert ops.body(cfg.ssm_head_dim, cfg.ssm_state,
                        min(256, S)) == "chunk_tf32x3", cfg.name


def test_cpu_calls_count_no_launch_of_either_body():
    t = _torch(_case(2, 64, 4, 32, 16, False, True, seed=5), torch.float32)
    before = (ops.ssd.launches, dict(ops.ssd.body_launches))
    ops.ssd(*(t[n] for n in NAMES), init_state=t["s0"], chunk=64)
    assert (ops.ssd.launches, ops.ssd.body_launches) == before
    assert set(ops.ssd.body_launches) == {"cuda_core", "chunk_tf32x3"}


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", EMULATED)
def test_chunk_body_arithmetic_matches_jax_kernel(case, kind, state):
    """The chunk body's split (chunk states, the scan, the outputs) and
    its 3xTF32 products, emulated in torch, within WKV_TOL of
    ``ssd_pallas`` in interpret mode."""
    B, S, H, P, N, chunk, strong = case
    jdt, tdt = DTYPES[kind]
    assert ops.body(P, N, chunk) == "chunk_tf32x3"
    x = _case(B, S, H, P, N, strong, state, seed=sum(case[:6]) + 1)
    if strong:
        cum = np.cumsum((x["dt"] * x["A"]).reshape(B, S // chunk, chunk, H),
                        2)
        assert cum.min() < -100
    t = _torch(x, tdt)
    y, sf = _ssd_chunk_emulated(*(t[n] for n in NAMES), t["s0"], chunk)
    assert y.dtype == tdt and y.shape == (B, S, H, P)
    s0 = None if x["s0"] is None else jnp.asarray(x["s0"])
    jy, js = jax_ssd(*_jax(x, jdt), init_state=s0, chunk=chunk,
                     interpret=True)
    ok, errs = within_wkv_tol(y, sf, np.asarray(jy.astype(jnp.float32)),
                               np.asarray(js), kind)
    assert ok, errs


@pytest.mark.parametrize("products", ["tf32", "bf16"])
def test_one_pass_products_break_the_tolerance(products):
    """Why 3xTF32: with one TF32 or one bf16 product the same arithmetic
    misses WKV_TOL against the JAX kernel at mamba2-2.7b's heads (f32
    inputs, a state given), where 3xTF32 holds it."""
    B, S, H, P, N, chunk, strong = EMULATED[1]
    x = _case(B, S, H, P, N, strong, True, seed=31)
    t = _torch(x, torch.float32)
    jy, js = jax_ssd(*_jax(x, jnp.float32), init_state=jnp.asarray(x["s0"]),
                     chunk=chunk, interpret=True)
    want = (np.asarray(jy), np.asarray(js))
    ins = [t[n] for n in NAMES]
    ok3, errs3 = within_wkv_tol(*_ssd_chunk_emulated(*ins, t["s0"], chunk),
                                 *want, "f32")
    assert ok3, errs3
    ok1, errs1 = within_wkv_tol(
        *_ssd_chunk_emulated(*ins, t["s0"], chunk, products=products),
        *want, "f32")
    assert not ok1 and max(errs1) > 2 * WKV_TOL, errs1
