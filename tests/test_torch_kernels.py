"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their plain versions; the JAX
kernels run in interpret mode, as ``repro.kernels.ops`` runs them here.
Both see the same seeded numpy inputs.  Tolerances are the JAX tests':
float32 2e-5 (decode) / 3e-5 (prefill), bfloat16 2e-2 / 3e-2.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py`` (this file imports JAX, which the machine with
the card does not have).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as jflash  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jpaged  # noqa: E402
from repro_torch.kernels import flash_prefill as fp_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import paged_prefill as pp_mod  # noqa: E402

torch.set_num_threads(1)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

PAGED_CASES = [
    # (B, H, Hkv, D, page, NB, dtype) — tests/test_kernels.py:21
    (4, 8, 4, 64, 16, 8, "float32"),
    (2, 8, 8, 128, 16, 4, "float32"),     # MHA
    (3, 16, 2, 64, 32, 4, "float32"),     # high group ratio
    (1, 4, 1, 256, 16, 8, "float32"),     # MQA, big head
    (4, 8, 4, 64, 16, 8, "bfloat16"),     # serving dtype
]

PREFILL_CASES = [
    # (B, H, Hkv, D, page) — tests/test_paged_prefill.py:27
    (2, 4, 4, 32, 8),
    (1, 8, 4, 64, 16),
    (2, 8, 2, 32, 16),
    (1, 4, 4, 64, 64),
    (2, 8, 2, 64, 64),
    (1, 8, 4, 32, 8),
]


FLASH_CASES = [
    # (B, Sq, Sk, H, Hkv, D, window, q_offset, dtype) — tests/test_kernels.py:59
    (2, 128, 128, 8, 4, 64, 0, 0, "float32"),
    (2, 128, 256, 4, 2, 64, 0, 128, "float32"),    # chunked prefill
    (1, 256, 256, 4, 1, 128, 64, 0, "float32"),    # sliding window MQA
    (2, 64, 64, 4, 4, 32, 0, 0, "float32"),
    (1, 192, 320, 6, 3, 64, 100, 128, "float32"),  # window + offset
    (2, 128, 128, 8, 4, 64, 0, 0, "bfloat16"),
]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (rounded once)."""
    j = jnp.asarray(a, JAX_DTYPES[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DTYPES[dtype])
    return j, t


def _ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def _decode_inputs(rng, b, h, hkv, d, page, nb, dtype, lengths=None):
    p = b * nb + 3
    q = _pair(rng.normal(size=(b, h, d)), dtype)
    kp = _pair(rng.normal(size=(p, page, hkv, d)), dtype)
    vp = _pair(rng.normal(size=(p, page, hkv, d)), dtype)
    bt = _ints(rng.permutation(p)[:b * nb].reshape(b, nb))
    if lengths is None:
        lengths = rng.integers(1, nb * page + 1, b)
    return q, kp, vp, bt, _ints(lengths)


def _prefill_inputs(rng, b, h, hkv, d, page, s=24, cap=192):
    nb = cap // page
    p = b * nb + 3
    kp = _pair(rng.normal(size=(p, page, hkv, d)), "float32")
    vp = _pair(rng.normal(size=(p, page, hkv, d)), "float32")
    bt = _ints(rng.permutation(p)[:b * nb].reshape(b, nb))
    ctx = _ints(rng.integers(0, cap - s + 1, b))
    chunk = _ints(rng.integers(1, s + 1, b))
    q = _pair(rng.normal(size=(b, s, h, d)), "float32")
    return q, kp, vp, bt, ctx, chunk


@pytest.mark.parametrize("b,h,hkv,d,page,nb,dtype", PAGED_CASES)
def test_paged_attention_matches_jax(b, h, hkv, d, page, nb, dtype):
    rng = np.random.default_rng(0)
    args = _decode_inputs(rng, b, h, hkv, d, page, nb, dtype)
    out = pa_mod.paged_attention(*(t for _, t in args))
    _close(out, jpaged(*(j for j, _ in args)),
           2e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("lengths", [[1, 1], [0, 37]],
                         ids=["length_one", "length_zero_row"])
def test_paged_attention_short_rows_match_jax(lengths):
    """A single-token cache, and an idle row (length 0) that the Pallas
    kernel and the port both answer with zeros."""
    rng = np.random.default_rng(1)
    args = _decode_inputs(rng, 2, 4, 2, 64, 16, 4, "float32", lengths)
    out = pa_mod.paged_attention(*(t for _, t in args))
    _close(out, jpaged(*(j for j, _ in args)), 2e-5)
    if lengths[0] == 0:
        assert torch.all(out[0] == 0)


SPLIT_NB = 6
SPLIT_CASES = [
    # (G, page, pages_per_split): G 1, 2 and 8, page 8 and 16, a split
    # of one page, of three, and of the whole table
    (1, 8, 1), (1, 16, 3), (1, 8, SPLIT_NB),
    (2, 16, 1), (2, 8, 3), (2, 16, SPLIT_NB),
    (8, 8, 1), (8, 16, 3), (8, 8, SPLIT_NB),
]


@pytest.mark.parametrize("g,page,pps", SPLIT_CASES)
def test_paged_attention_split_ref_matches_jax(g, page, pps):
    """The plain mirror of the split kernel (per-split max, sum and
    accumulator, merged in split order) against the Pallas kernel and
    the port's one-softmax plain version, over rows of length 0, 1, at a
    split boundary, one past it and the whole table."""
    rng = np.random.default_rng(20)
    span, full = pps * page, SPLIT_NB * page
    lengths = [0, 1, span, min(span + 1, full), full]
    args = _decode_inputs(rng, len(lengths), 2 * g, 2, 32, page, SPLIT_NB,
                          "float32", lengths)
    tq = [t for _, t in args]
    out = ref.paged_attention_split_ref(*tq, pages_per_split=pps)
    _close(out, jpaged(*(j for j, _ in args)), 2e-5)
    torch.testing.assert_close(out, ref.paged_attention_ref(*tq),
                               atol=2e-5, rtol=2e-5)
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("b,hkv,nb,page,want", [
    (8, 8, 52, 16, (11, 5)),      # the serving shapes: 64 blocks -> 320
    (1, 8, 256, 16, (8, 32)),     # one long request: 8 blocks -> 256
    (8, 2, 52, 16, (4, 13)),      # glm4-9b's group shape
    (64, 8, 52, 16, (52, 1)),     # 512 blocks fill the card
    (1, 1, 4, 16, (4, 1)),        # a table of 64 tokens: too narrow
    (2, 2, 4, 64, (1, 4)),        # 64-token pages: a page a split
    (3, 5, 7, 8, (7, 1)),         # 56 tokens, under one split's least
    (1, 1, 1000, 16, (8, 125)),   # at most MAX_SPLITS splits
])
def test_split_plan(b, hkv, nb, page, want):
    """The host's split: pure, deterministic, covering the table with
    no empty split, one split where the card is full or the table
    narrow, else at most a few waves of blocks of real work."""
    plan = pa_mod.split_plan(b, hkv, nb, page, num_sms=132)
    assert plan == want == pa_mod.split_plan(b, hkv, nb, page, num_sms=132)
    pps, n = plan
    assert n * pps >= nb and (n - 1) * pps < nb and n <= pa_mod.MAX_SPLITS
    if b * hkv >= 132 or nb * page <= pa_mod.MIN_SPLIT_TOKENS:
        assert n == 1
    else:
        assert pps * page >= pa_mod.MIN_SPLIT_TOKENS
        assert b * hkv * n <= 3 * 132 or pps * page == \
            pa_mod.MIN_SPLIT_TOKENS


@pytest.mark.parametrize("b,h,hkv,d,page", PREFILL_CASES)
def test_paged_prefill_matches_jax(b, h, hkv, d, page):
    rng = np.random.default_rng(7)
    args = _prefill_inputs(rng, b, h, hkv, d, page)
    out = ops.paged_prefill(*(t for _, t in args))
    _close(out, jops.paged_prefill(*(j for j, _ in args)), 3e-5)


def test_paged_prefill_zero_ctx_matches_jax_and_flash():
    """A first chunk (ctx=0): the port equals the Pallas kernel and the
    JAX package's contiguous flash-prefill oracle."""
    rng = np.random.default_rng(8)
    b, s, h, hkv, d, page = 1, 32, 4, 2, 32, 8
    nb = s // page
    kp = _pair(rng.normal(size=(nb + 1, page, hkv, d)), "float32")
    vp = _pair(rng.normal(size=(nb + 1, page, hkv, d)), "float32")
    q = _pair(rng.normal(size=(b, s, h, d)), "float32")
    bt, ctx, chunk = _ints([range(nb)]), _ints([0]), _ints([s])
    args = (q, kp, vp, bt, ctx, chunk)
    out = ops.paged_prefill(*(t for _, t in args))
    _close(out, jops.paged_prefill(*(j for j, _ in args)), 3e-5)
    flash = jref.flash_prefill_ref(
        q[0], kp[0][:nb].reshape(1, s, hkv, d),
        vp[0][:nb].reshape(1, s, hkv, d), jnp.full(b, s, jnp.int32))
    _close(out, flash, 3e-5)


def test_paged_prefill_padding_rows_are_zero():
    rng = np.random.default_rng(9)
    b, s, h, hkv, d, page, nb = 2, 16, 4, 2, 32, 8, 4
    kp = _pair(rng.normal(size=(b * nb + 1, page, hkv, d)), "float32")
    vp = _pair(rng.normal(size=(b * nb + 1, page, hkv, d)), "float32")
    q = _pair(rng.normal(size=(b, s, h, d)), "float32")
    bt = _ints(np.arange(b * nb).reshape(b, nb))
    args = (q, kp, vp, bt, _ints([8, 0]), _ints([5, 12]))
    out = ops.paged_prefill(*(t for _, t in args))
    _close(out, jops.paged_prefill(*(j for j, _ in args)), 3e-5)
    for i, c in enumerate([5, 12]):
        assert torch.all(out[i, c:] == 0)
        assert torch.any(out[i, :c] != 0)


def test_paged_prefill_bf16_matches_jax():
    rng = np.random.default_rng(10)
    b, h, hkv, d, page, s, nb = 2, 8, 4, 64, 16, 24, 12
    p = b * nb + 3
    kp = _pair(rng.normal(size=(p, page, hkv, d)), "bfloat16")
    vp = _pair(rng.normal(size=(p, page, hkv, d)), "bfloat16")
    q = _pair(rng.normal(size=(b, s, h, d)), "bfloat16")
    bt = _ints(rng.permutation(p)[:b * nb].reshape(b, nb))
    args = (q, kp, vp, bt, _ints([40, 0]), _ints([24, 17]))
    out = ops.paged_prefill(*(t for _, t in args))
    _close(out, jops.paged_prefill(*(j for j, _ in args)), 3e-2)


def test_cpu_wrappers_take_plain_version_without_launching():
    rng = np.random.default_rng(11)
    args = _decode_inputs(rng, 2, 4, 2, 32, 8, 4, "float32")
    before = (pa_mod.launches, pp_mod.launches)
    out = ops.paged_attention(*(t for _, t in args))
    torch.testing.assert_close(
        out, ref.paged_attention_ref(*(t for _, t in args)))
    pre = _prefill_inputs(rng, 1, 4, 2, 32, 8)
    ops.paged_prefill(*(t for _, t in pre))
    assert (pa_mod.launches, pp_mod.launches) == before


def test_ops_rejects_unknown_impl():
    rng = np.random.default_rng(12)
    args = _decode_inputs(rng, 1, 4, 2, 32, 8, 2, "float32")
    with pytest.raises(ValueError, match="impl"):
        ops.paged_attention(*(t for _, t in args), impl="pallas")



def _flash_inputs(rng, b, sq, sk, h, hkv, d, dtype, lengths=None):
    q = _pair(rng.normal(size=(b, sq, h, d)), dtype)
    k = _pair(rng.normal(size=(b, sk, hkv, d)), dtype)
    v = _pair(rng.normal(size=(b, sk, hkv, d)), dtype)
    if lengths is None:
        lengths = rng.integers(sk // 2, sk + 1, b)
    return q, k, v, _ints(lengths)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,win,qoff,dtype", FLASH_CASES)
def test_flash_prefill_matches_jax(b, sq, sk, h, hkv, d, win, qoff, dtype):
    """The port's wrapper (its plain version on the CPU) against the
    Pallas kernel in interpret mode, at the JAX test's blocks."""
    rng = np.random.default_rng(13)
    args = _flash_inputs(rng, b, sq, sk, h, hkv, d, dtype)
    out = fp_mod.flash_prefill(*(t for _, t in args), window=win,
                               q_offset=qoff)
    want = jflash(*(j for j, _ in args), window=win, q_offset=qoff,
                  block_q=64, block_k=64)
    _close(out, want, 3e-5 if dtype == "float32" else 3e-2)


def test_flash_attention_ragged_matches_jax_ops():
    """Sequence lengths that are no block multiple: the JAX wrapper pads
    them, the port's kernel masks the edges itself."""
    rng = np.random.default_rng(14)
    args = _flash_inputs(rng, 2, 100, 173, 4, 2, 64, "float32", [173, 90])
    out = ops.flash_attention(*(t for _, t in args))
    _close(out, jops.flash_attention(*(j for j, _ in args), block_q=64,
                                     block_k=64), 3e-5)


def test_flash_prefill_rows_without_keys_are_zero():
    """Under a window, rows at ``qpos >= lengths + window - 1`` see no
    key: zeros in the Pallas kernel, the JAX oracle and the port."""
    rng = np.random.default_rng(15)
    args = _flash_inputs(rng, 2, 64, 64, 4, 2, 32, "float32", [64, 20])
    out = ops.flash_attention(*(t for _, t in args), window=16)
    jq = [j for j, _ in args]
    kernel = jflash(*jq, window=16, block_q=32, block_k=32)
    oracle = jref.flash_prefill_ref(*jq, window=16)
    _close(out, kernel, 3e-5)
    _close(out, oracle, 3e-5)
    assert torch.all(out[1, 35:] == 0)
    assert np.all(np.asarray(kernel)[1, 35:] == 0)
    assert torch.all(out[1, :35].abs().sum(-1) > 0)


def test_cpu_flash_wrapper_takes_plain_version_without_launching():
    rng = np.random.default_rng(16)
    args = [t for _, t in _flash_inputs(rng, 1, 24, 24, 4, 2, 32,
                                        "float32")]
    before = fp_mod.launches
    for impl in ("kernel", "ref"):
        torch.testing.assert_close(
            ops.flash_attention(*args, window=8, impl=impl),
            ref.flash_prefill_ref(*args, window=8))
    assert fp_mod.launches == before
    with pytest.raises(ValueError, match="window"):
        fp_mod.flash_prefill(*args, window=-1)


@pytest.mark.parametrize("d,dtype,accepted", [
    (48, "bfloat16", True), (40, "bfloat16", False),
    (320, "bfloat16", False), (32, "float32", True), (8, "float32", True),
    (256, "float32", True), (36, "float32", False),
    (264, "float32", False)],
    ids=["bf16_d48", "bf16_d40", "bf16_d320", "f32_d32", "f32_d8",
         "f32_d256", "f32_d36", "f32_d264"])
def test_tile_head_dim_rule(d, dtype, accepted):
    """Both prefill bodies run on the tensor cores, at most 256 wide:
    bf16 in steps of 16 along D, float32 (3xTF32) in steps of 8; the
    check runs before a launch and is pure Python, so it is held here on
    CPU tensors."""
    from repro_torch.kernels import common
    q = torch.zeros(1, 4, 4, d, dtype=TORCH_DTYPES[dtype])
    k = torch.zeros(1, 4, 2, d, dtype=TORCH_DTYPES[dtype])
    common.check_dense(q, k, k.clone())
    if accepted:
        common.check_tile_head_dim(q)
    else:
        step = 16 if dtype == "bfloat16" else 8
        with pytest.raises(ValueError, match=f"multiple of {step} and at "
                           "most 256"):
            common.check_tile_head_dim(q)


# ---------------------------------------------------------------- 3xTF32
# The float32 tile (csrc/attn_tile_f32.cuh) takes each float32 product
# as three TF32 products on the tensor cores.  The card cannot be asked
# here, so its arithmetic is emulated on CPU tensors and held to the JAX
# reference at the float32 prefill tolerance: TF32 rounding as cvt.rna
# does it, each product split as the kernel splits it (P too), the three
# products in the kernel's order, float32 sums, S in partials of 32
# columns of D, PV a fresh accumulator a key tile, the online softmax as
# the kernel runs it over its key tiles, split between two warps and
# merged.  One TF32 product (the small terms lost) must miss the same
# bar.

F32_NEG = float(np.float32(-0.7) * np.finfo(np.float32).max)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mma(acc, a, b, terms):
    """acc + a @ b for one k-step of 8, as ``mma_3xtf32`` (terms 3) or one
    TF32 product (terms 1): products of TF32 values are exact in
    float32."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    if terms == 3:
        acc = acc + as_ @ bb
        acc = acc + ab @ bs
    return acc + ab @ bb


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _tile_emulation(q, k, v, visible, scale, terms=3):
    """The float32 tile's arithmetic: q (..., R, D), k and v (..., K, D),
    visible (..., R, K) -> (..., R, D); D padded to the tile's DP, key
    tiles of its NK, each split between two warps (keys 0..NK/2-1 and
    NK/2..NK-1 of every tile), each with its own online softmax, merged
    at the end."""
    import torch.nn.functional as F
    d = q.shape[-1]
    dp = next(p for p in (32, 64, 128, 256) if d <= p)
    nk = 64 if dp <= 64 else 32
    nw = nk // 2                                   # keys a warp a tile
    parts = 2                                      # partial sums of S
    kpad = -k.shape[-2] % nk
    q = F.pad(q, (0, dp - d))
    k = F.pad(k, (0, dp - d, 0, kpad))
    v = F.pad(v, (0, dp - d, 0, kpad))
    visible = F.pad(visible, (0, kpad))
    sl2 = torch.tensor(np.float32(np.float32(scale)
                                  * np.float32(1.4426950408889634)))
    neg = torch.tensor(F32_NEG)
    warps = []
    for h in range(2):
        o = torch.zeros(q.shape)
        m = torch.full(q.shape[:-1], F32_NEG)
        l = torch.zeros(q.shape[:-1])
        for k0 in range(h * nw, k.shape[-2], nk):
            kt, vt = k[..., k0:k0 + nw, :], v[..., k0:k0 + nw, :]
            vis = visible[..., k0:k0 + nw]
            sc = torch.zeros(vis.shape)
            for c in range(0, dp, 32):
                part = [torch.zeros(vis.shape) for _ in range(parts)]
                for i, kk in enumerate(range(c, c + 32, 8)):
                    part[i % parts] = _mma(
                        part[i % parts], q[..., kk:kk + 8],
                        kt[..., kk:kk + 8].transpose(-1, -2), terms)
                for x in part:
                    sc = sc + x
            x = torch.where(vis, sc, neg)
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2((m - mx) * sl2)
            p = torch.where(vis, torch.exp2(_fma(x, sl2,
                                                 (-mx * sl2)[..., None])),
                            torch.tensor(0.0))
            l = l * alpha + p.sum(-1)
            m = mx
            pv = torch.zeros(o.shape)
            for kk in range(0, nw, 8):
                pv = _mma(pv, p[..., kk:kk + 8], vt[..., kk:kk + 8, :],
                          terms)
            o = _fma(o, alpha[..., None], pv)
        warps.append((o, m, l))
    (o, m, l), (ob, mb, lb) = warps
    mx = torch.maximum(m, mb)
    a, b = torch.exp2((m - mx) * sl2), torch.exp2((mb - mx) * sl2)
    l = l * a + lb * b
    o = _fma(o, a[..., None], ob * b[..., None])
    return (o * (1 / l.clamp(min=1e-30))[..., None])[..., :d]


def _emulate_paged_prefill(q, kp, vp, bt, ctx, chunk, terms=3):
    """paged_prefill through the emulated tile: the G heads of a KV group
    folded into its rows, keys gathered through the block tables."""
    b, s, h, d = q.shape
    _, page, hkv, _ = kp.shape
    g, n = h // hkv, bt.shape[1] * page
    k = kp[bt.long()].reshape(b, n, hkv, d).transpose(1, 2)
    v = vp[bt.long()].reshape(b, n, hkv, d).transpose(1, 2)
    rows = q.reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, g * s, d)
    j = torch.arange(s).repeat(g)                       # row -> chunk row
    kpos = torch.arange(n)
    vis = ((kpos[None, None] <= (ctx[:, None] + j[None])[..., None])
           & (kpos[None, None] < (ctx + chunk)[:, None, None])
           & (j[None, :, None] < chunk[:, None, None]))[:, None]
    out = _tile_emulation(rows, k, v, vis, d ** -0.5, terms)
    return out.reshape(b, hkv, g, s, d).permute(0, 3, 1, 2, 4).reshape(
        b, s, h, d)


def _emulate_flash(q, k, v, lengths, window=0, q_offset=0, terms=3):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    rows = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, g * sq, d)
    qpos = torch.arange(sq).repeat(g) + q_offset
    kpos = torch.arange(sk)
    vis = kpos[None] <= qpos[:, None]
    if window:
        vis &= kpos[None] > qpos[:, None] - window
    vis = (vis[None] & (kpos[None, None] < lengths[:, None, None]))[:, None]
    out = _tile_emulation(rows, k.transpose(1, 2), v.transpose(1, 2), vis,
                          d ** -0.5, terms)
    return out.reshape(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4).reshape(
        b, sq, h, d)


@pytest.mark.parametrize("b,h,hkv,d,page", PREFILL_CASES)
def test_3xtf32_tile_paged_prefill_matches_jax(b, h, hkv, d, page):
    rng = np.random.default_rng(7)
    args = _prefill_inputs(rng, b, h, hkv, d, page)
    out = _emulate_paged_prefill(*(t for _, t in args))
    _close(out, jops.paged_prefill(*(j for j, _ in args)), 3e-5)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,win,qoff",
                         [c[:8] for c in FLASH_CASES if c[8] == "float32"]
                         + [(1, 256, 256, 4, 2, 256, 0, 0),
                            (1, 200, 200, 4, 2, 256, 64, 0)])
def test_3xtf32_tile_flash_prefill_matches_jax(b, sq, sk, h, hkv, d, win,
                                               qoff):
    """The JAX test's float32 cases, then gemma3-4b's D 256 with and
    without a window (against the JAX oracle; the Pallas kernel in
    interpret mode is slow at that width)."""
    rng = np.random.default_rng(13)
    args = _flash_inputs(rng, b, sq, sk, h, hkv, d, "float32")
    out = _emulate_flash(*(t for _, t in args), window=win, q_offset=qoff)
    jq = [j for j, _ in args]
    want = (jref.flash_prefill_ref(*jq, window=win, q_offset=qoff)
            if d == 256 else jflash(*jq, window=win, q_offset=qoff,
                                    block_q=64, block_k=64))
    _close(out, want, 3e-5)


@pytest.mark.parametrize("kernel", ["paged_prefill", "flash_prefill"])
def test_1xtf32_tile_misses_the_float32_bar(kernel):
    """One TF32 product a float32 product (the small terms dropped) is
    ~1e-3 off: the 3xTF32 tests above would catch a lost small term."""
    rng = np.random.default_rng(17)
    if kernel == "paged_prefill":
        args = _prefill_inputs(rng, 2, 8, 2, 64, 16)
        got = _emulate_paged_prefill(*(t for _, t in args), terms=1)
        want = jops.paged_prefill(*(j for j, _ in args))
    else:
        args = _flash_inputs(rng, 1, 256, 256, 4, 2, 256, "float32")
        got = _emulate_flash(*(t for _, t in args), terms=1)
        want = jref.flash_prefill_ref(*(j for j, _ in args))
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err > 1e-4, err
    with pytest.raises(AssertionError):
        _close(got, want, 3e-5)
