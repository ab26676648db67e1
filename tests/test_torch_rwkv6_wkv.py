"""The plain versions of kernel B4 (``kernels/rwkv6_wkv/ref.py``) and its
wrapper ``ops.wkv`` against the JAX kernel ``wkv_pallas`` (interpret
mode, as ``tests/test_kernels.py`` runs it), the JAX oracle ``wkv_ref``
and ``jax.grad`` of the JAX model's chunked twin.

Inputs are drawn with numpy from a seed and cross to both frameworks as
numpy arrays, in the cases of ``tests/test_kernels.py``'s WKV sweep.

Tolerances: both sides compute in f32, in other summation orders, so
in f32 y and the state agree within 1e-5 of their largest magnitude
(measured: at most 1.2e-6).  With bf16 inputs the state stays f32 (the
same 1e-5) and y rounds once to bf16 on both sides, so each element is
held to one bf16 ulp of itself (2^-7 of its magnitude); an f32 result
near a rounding boundary may round the other way.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _tf32x3 import WKV_TOL, mm, within_wkv_tol
from repro.kernels.rwkv6_wkv.kernel import wkv_pallas
from repro.kernels.rwkv6_wkv.ref import wkv_ref as jax_wkv_ref
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
from repro_torch.kernels.rwkv6_wkv import ops
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked_ref, wkv_ref

CASES = [                       # (B, S, H, N, chunk, with_state)
    (1, 32, 1, 8, 8, False),
    (2, 64, 3, 16, 16, True),
    (1, 64, 2, 16, 64, False),  # chunk == S
    (2, 48, 2, 8, 16, True),    # S % 32 != 0
]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(B, S, H, N, with_state, seed=0):
    r = np.random.default_rng(seed)
    mk = lambda *s, sc=0.5: (r.normal(size=s) * sc).astype(np.float32)
    return {"r": mk(B, S, H, N), "k": mk(B, S, H, N), "v": mk(B, S, H, N),
            "lw": (-np.abs(r.normal(size=(B, S, H, N))) * 0.3).astype(
                np.float32),
            "u": mk(H, N, sc=0.1),
            "s0": (mk(B, H, N, N, sc=0.2) if with_state
                   else np.zeros((B, H, N, N), np.float32))}


def _torch(x, dt):
    return {n: torch.tensor(a).to(torch.float32 if n == "s0" else dt)
            for n, a in x.items()}


def _jax_kernel(x, chunk, jdt):
    """wkv_pallas in interpret mode on the flat (B*H, S, N) layout, back
    in (B, S, H, N)."""
    B, S, H, N = x["r"].shape
    flat = lambda a: jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3) \
        .reshape(B * H, S, N)
    u = jnp.broadcast_to(jnp.asarray(x["u"]).astype(jdt), (B, H, N))
    y, sf = wkv_pallas(flat(x["r"]), flat(x["k"]), flat(x["v"]),
                       flat(x["lw"]), u.reshape(B * H, N),
                       jnp.asarray(x["s0"]).reshape(B * H, N, N),
                       chunk=chunk, interpret=True)
    y = np.asarray(y.astype(jnp.float32)).reshape(B, H, S, N)
    return y.transpose(0, 2, 1, 3), np.asarray(sf).reshape(B, H, N, N)


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


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_chunked_plain_matches_jax_kernel(case, kind):
    B, S, H, N, chunk, ws = case
    jdt, tdt = DTYPES[kind]
    x = _case(B, S, H, N, ws, seed=sum(case[:5]))
    t = _torch(x, tdt)
    y, sf = wkv_chunked_ref(t["r"], t["k"], t["v"], t["lw"], t["u"],
                            init_state=t["s0"], chunk=chunk)
    assert y.dtype == tdt and y.shape == (B, S, H, N)
    _close(y, sf, *_jax_kernel(x, chunk, jdt), kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_sequential_plain_matches_jax_oracle(case, kind):
    B, S, H, N, _, ws = case
    jdt, tdt = DTYPES[kind]
    x = _case(B, S, H, N, ws, seed=sum(case[:5]))
    flat_j = lambda a: jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3) \
        .reshape(B * H, S, N)
    u_j = jnp.broadcast_to(jnp.asarray(x["u"]).astype(jdt),
                           (B, H, N)).reshape(B * H, N)
    jy, js = jax_wkv_ref(flat_j(x["r"]), flat_j(x["k"]), flat_j(x["v"]),
                         flat_j(x["lw"]), u_j,
                         jnp.asarray(x["s0"]).reshape(B * H, N, N))
    t = _torch(x, tdt)
    flat_t = lambda a: a.permute(0, 2, 1, 3).reshape(B * H, S, N)
    y, sf = wkv_ref(flat_t(t["r"]), flat_t(t["k"]), flat_t(t["v"]),
                    flat_t(t["lw"]),
                    t["u"][None].expand(B, H, N).reshape(B * H, N),
                    t["s0"].reshape(B * H, N, N))
    _close(y, sf, np.asarray(jy.astype(jnp.float32)), np.asarray(js), kind)


@pytest.mark.parametrize("case", CASES)
def test_wrapper_on_the_cpu_is_the_plain_version(case):
    """On CPU tensors ``ops.wkv`` runs ``wkv_chunked_ref`` (bit for bit)
    and counts no kernel launch; chunk > S means chunk = S."""
    B, S, H, N, chunk, ws = case
    t = _torch(_case(B, S, H, N, ws, seed=3), torch.float32)
    s0 = t["s0"] if ws else None
    before = ops.wkv.launches
    y, sf = ops.wkv(t["r"], t["k"], t["v"], t["lw"], t["u"], init_state=s0,
                    chunk=chunk)
    want = wkv_chunked_ref(t["r"], t["k"], t["v"], t["lw"], t["u"],
                           init_state=s0, chunk=chunk)
    assert torch.equal(y, want[0]) and torch.equal(sf, want[1])
    assert ops.wkv.launches == before
    y2, _ = ops.wkv(t["r"], t["k"], t["v"], t["lw"], t["u"], init_state=s0,
                    chunk=4 * S)
    torch.testing.assert_close(
        y2, wkv_chunked_ref(t["r"], t["k"], t["v"], t["lw"], t["u"],
                            init_state=s0, chunk=S)[0], rtol=0, atol=0)


def _weights(B, S, H, N, seed=9):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, H, N)).astype(np.float32),
            r.normal(size=(B, H, N, N)).astype(np.float32))


@pytest.mark.parametrize("case", [(2, 64, 3, 16, 16, True),
                                  (2, 48, 2, 8, 16, False)])
def test_function_gradients_match_autograd_and_jax_grad(case):
    """The ``WKV`` Function's recomputed gradients equal autograd through
    the plain version, and ``jax.grad`` of the JAX model's chunked twin
    in f32 within 1e-4 of each gradient's scale; du is summed over the
    batch (u is shared), and ds0 is returned when a state was given."""
    B, S, H, N, chunk, ws = case
    x = _case(B, S, H, N, ws, seed=21)
    wy, ws_ = _weights(B, S, H, N)
    names = ["r", "k", "v", "lw", "u"] + (["s0"] if ws else [])

    def port(fn):
        t = {n: torch.tensor(a).requires_grad_() for n, a in x.items()}
        y, sf = fn(t["r"], t["k"], t["v"], t["lw"], t["u"],
                   init_state=t["s0"] if ws else None, chunk=chunk)
        ((y * torch.tensor(wy)).sum()
         + (sf * torch.tensor(ws_)).sum()).backward()
        return {n: t[n].grad for n in names}

    got = port(ops.wkv)
    plain = port(wkv_chunked_ref)
    for n in names:
        torch.testing.assert_close(got[n], plain[n], rtol=0, atol=0)
    assert got["u"].shape == (H, N)

    def jloss(*args):
        r, k, v, lw, u = args[:5]
        y, sf = jax_wkv_chunked(r, k, v, lw, u, chunk=chunk,
                                init_state=args[5] if ws else None)
        return jnp.sum(y * wy) + jnp.sum(sf * ws_)

    jg = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(x[n]) for n in names))
    for n, want in zip(names, jg):
        want = np.asarray(want)
        err = np.abs(got[n].numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (n, err)


def test_bf16_gradients_keep_the_input_dtypes():
    x = _case(1, 32, 2, 8, True, seed=4)
    t = {n: torch.tensor(a).to(torch.float32 if n == "s0"
                               else torch.bfloat16).requires_grad_()
         for n, a in x.items()}
    y, sf = ops.wkv(t["r"], t["k"], t["v"], t["lw"], t["u"],
                    init_state=t["s0"], chunk=8)
    (y.float().sum() + sf.sum()).backward()
    for n, a in t.items():
        assert a.grad.dtype == a.dtype and torch.isfinite(a.grad).all(), n


def _ops_args(B=1, S=16, H=2, N=8, dt=torch.float32):
    z = lambda *s: torch.zeros(s, dtype=dt)
    return [z(B, S, H, N), z(B, S, H, N), z(B, S, H, N), z(B, S, H, N),
            z(H, N)]


@pytest.mark.parametrize("arg,value,err", [
    (1, torch.zeros(1, 16, 2, 4), ValueError),            # k's shape
    (4, torch.zeros(3, 8), ValueError),                   # u's shape
    (2, torch.zeros(1, 16, 2, 8, dtype=torch.bfloat16), TypeError),
    (4, torch.zeros(2, 8, dtype=torch.bfloat16), TypeError),
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
        ops.wkv(*args, **kw)


def test_rejects_half_wide_heads_and_long_chunks():
    with pytest.raises(TypeError):
        ops.wkv(*_ops_args(dt=torch.float16))
    with pytest.raises(ValueError, match="N <= 128"):
        ops.wkv(*_ops_args(N=136))
    with pytest.raises(ValueError, match="chunk"):
        ops.wkv(*_ops_args(S=512), chunk=256)


def test_other_devices_raise_instead_of_falling_back():
    args = [t.to("meta") for t in _ops_args()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.wkv(*args)


# ---------------------------------------------------------------------------
# The chunk body (csrc/rwkv6_wkv_chunk.cu): its routing, and its
# arithmetic emulated in torch against the JAX kernel
# ---------------------------------------------------------------------------

def _wkv_chunk_emulated(r, k, v, lw, u, s0, chunk, products="tf32x3"):
    """The chunk body's arithmetic in torch, launch by launch: (1) cum
    summed row by row in f32, each chunk's own state (k exp(last -
    cum))^T v and exp(last); (2) the entering states, S tot + st; (3) ri
    = r exp(cum - lw), kj = k exp(-cum), A = ri kj^T below the diagonal
    with sum_c r u k on it, y = A v + ri S, rounded once."""
    B, S, H, N = r.shape
    Q, nc = chunk, S // chunk
    f32 = lambda t: t.float().reshape(B, nc, Q, H, N).transpose(2, 3)
    rc, kc, vc, lwc = f32(r), f32(k), f32(v), f32(lw)      # (B,nc,H,Q,N)
    cum = torch.empty_like(lwc)
    run = torch.zeros_like(lwc[..., 0, :])
    for i in range(Q):
        run = run + lwc[..., i, :]
        cum[..., i, :] = run
    last = cum[..., -1:, :]
    st = mm((kc * torch.exp(last - cum)).transpose(-1, -2), vc, products)
    tot = torch.exp(last[..., 0, :])                        # (B,nc,H,N)
    state = (torch.zeros((B, H, N, N)) if s0 is None else s0.float())
    enter = []
    for c in range(nc):
        enter.append(state)
        state = state * tot[:, c, :, :, None] + st[:, c]
    enter = torch.stack(enter, 1)
    ri = rc * torch.exp(cum - lwc)
    kj = kc * torch.exp(-cum)
    A = torch.tril(mm(ri, kj.transpose(-1, -2), products), -1)
    A = A + torch.diag_embed((rc * u.float()[:, None, :] * kc).sum(-1))
    y = mm(A, vc, products) + mm(ri, enter, products)
    return y.transpose(2, 3).reshape(B, S, H, N).to(r.dtype), state


def _strongest(x):
    """The clamp's edge: lw in [-0.35, -0.3], so cum reaches ~-45 across
    a 128-row chunk and ri, kj span e^+-45."""
    r = np.random.default_rng(7)
    x["lw"] = (-0.3 - 0.05 * r.random(x["lw"].shape)).astype(np.float32)
    return x


EMULATED = [                     # (B, S, H, N, chunk, strongest decay)
    (2, 128, 4, 16, 64, False),  # rwkv6-3b smoke width
    (1, 256, 2, 64, 128, False),  # rwkv6-3b's heads, two chunks
    (1, 256, 2, 64, 128, True),   # lw at the clamp's edge
]


@pytest.mark.parametrize("N,Q,want", [
    (64, 128, "chunk_tf32x3"),   # rwkv6-3b training
    (16, 64, "chunk_tf32x3"),    # smoke width, chip_smoke phase 3d
    (16, 128, "chunk_tf32x3"),
    (64, 32, "chunk_tf32x3"),
    (64, 48, "cuda_core"),       # chunk not a multiple of 32
    (8, 16, "cuda_core"),        # N below the MMA's depth
    (128, 128, "cuda_core"),     # N past 64: the block's tiles overflow
    (10, 30, "cuda_core"),
])
def test_body_routes_the_training_and_smoke_shapes_to_the_chunk_body(
        N, Q, want):
    """The router reads the widths alone: bf16 and f32 operands of one
    shape take the same body."""
    assert ops.body(N, Q) == want


def test_the_models_route_to_the_chunk_body():
    """rwkv6-3b at its training shape (chunk 128 at seq 4096) and its
    smoke config at the CLI's smoke shape (seq 128)."""
    from repro_torch.configs import get_config, get_smoke

    for cfg, S in ((get_config("rwkv6-3b"), 4096),
                   (get_smoke("rwkv6-3b"), 128)):
        assert ops.body(cfg.rwkv_head_dim, min(128, S)) == "chunk_tf32x3", \
            cfg.name


def test_cpu_calls_count_no_launch_of_either_body():
    t = _torch(_case(2, 128, 4, 16, True, seed=5), torch.float32)
    before = (ops.wkv.launches, dict(ops.wkv.body_launches))
    ops.wkv(t["r"], t["k"], t["v"], t["lw"], t["u"], init_state=t["s0"],
            chunk=64)
    assert (ops.wkv.launches, ops.wkv.body_launches) == before
    assert set(ops.wkv.body_launches) == {"cuda_core", "chunk_tf32x3"}


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", EMULATED)
def test_chunk_body_arithmetic_matches_jax_kernel(case, kind, state):
    """The chunk body's split (chunk states, the scan, the outputs) and
    its 3xTF32 products, emulated in torch, within WKV_TOL of
    ``wkv_pallas`` in interpret mode."""
    B, S, H, N, chunk, strongest = case
    jdt, tdt = DTYPES[kind]
    assert ops.body(N, chunk) == "chunk_tf32x3"
    x = _case(B, S, H, N, state, seed=sum(case[:5]) + 1)
    if strongest:
        x = _strongest(x)
    t = _torch(x, tdt)
    y, sf = _wkv_chunk_emulated(t["r"], t["k"], t["v"], t["lw"], t["u"],
                                t["s0"] if state else None, chunk)
    assert y.dtype == tdt and y.shape == (B, S, H, N)
    ok, errs = within_wkv_tol(y, sf, *_jax_kernel(x, chunk, jdt), kind)
    assert ok, errs


@pytest.mark.parametrize("products", ["tf32", "bf16"])
def test_one_pass_products_break_the_tolerance(products):
    """Why 3xTF32: with one TF32 or one bf16 product the same arithmetic
    misses WKV_TOL against the JAX kernel at rwkv6-3b's heads (f32
    inputs, a state given), where 3xTF32 holds it."""
    B, S, H, N, chunk, _ = EMULATED[1]
    x = _case(B, S, H, N, True, seed=31)
    t = _torch(x, torch.float32)
    want = _jax_kernel(x, chunk, jnp.float32)
    ins = [t[n] for n in ("r", "k", "v", "lw", "u", "s0")]
    ok3, errs3 = within_wkv_tol(*_wkv_chunk_emulated(*ins, chunk), *want,
                                 "f32")
    assert ok3, errs3
    ok1, errs1 = within_wkv_tol(
        *_wkv_chunk_emulated(*ins, chunk, products=products), *want, "f32")
    assert not ok1 and max(errs1) > 2 * WKV_TOL, errs1
