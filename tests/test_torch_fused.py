"""The fused elementwise kernels of the paged step
(``kernels/fused_elementwise.py``) against the plain compositions of
``models.layers`` that the paged model ran before them.

CPU cases hold each wrapper's CPU path to that composition bit for bit.
Cases marked ``chip`` run the CUDA kernels on the card against the same
composition on the same CUDA tensors, and skip without one: bf16 within
one unit in the last place (the kernels round once where the chain
rounds the activation before the product, and sum the norm's squares in
another order), float32 within 1e-6 relative; RoPE and the residual sum
round as the chain does and must agree bit for bit.  Shapes: the
benchmark's deepseek-coder-6.7b (T 2,112 on the card, 40 rows on the
CPU), qwen3-0.6b's (G 2, D 64, ``qk_norm``) and granite's (G 3, MoE).
This file imports no JAX: the card runs it.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import paged_model as PM  # noqa: E402
from repro_torch.kernels import fused_elementwise as fused  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

# (d, H, Hkv, D, F)
SHAPES = {
    "deepseek-coder-6.7b": (4096, 32, 32, 128, 11008),
    "qwen3-0.6b": (1024, 16, 8, 64, 3072),
    "granite-moe-3b-a800m": (1536, 24, 8, 64, 512),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ROWS = {"cpu": 40, "cuda": 2112}
PAGE, EPS, THETA = 16, 1e-6, 100000.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, dtype, device, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(
        dtype)


def _gen(device, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    """bf16: within one unit in the last place of the larger; float32:
    within 1e-6 relative."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        return
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert bool(((g - w).abs() <= ulp).all()), \
        f"max gap {(g - w).abs().max().item()} beyond one ulp"


# ------------------------------------------------------------ add + norm
def _norm_case(shape, dtype, device, with_delta):
    d = SHAPES[shape][0]
    gen = _gen(device, 1)
    t = ROWS[device.type]
    x = _randn((1, t, d), dtype, device, gen)
    delta = _randn((1, t, d), dtype, device, gen, 0.5) if with_delta \
        else None
    scale = _randn((d,), dtype, device, gen, 0.1)
    return x, delta, scale


@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_add_rms_norm_cpu_is_the_plain_composition(shape, dtype, with_delta):
    x, delta, scale = _norm_case(shape, DTYPES[dtype], torch.device("cpu"),
                                 with_delta)
    want_x = x + delta if with_delta else x
    want_h = layers.rms_norm(want_x, scale, EPS)
    for impl in ("kernel", "ref"):
        got_x, got_h = kops.add_rms_norm(x, delta, scale, EPS, impl=impl)
        assert torch.equal(got_x, want_x) and torch.equal(got_h, want_h)


@pytest.mark.chip
@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_add_rms_norm_kernel(cuda, shape, dtype, with_delta):
    x, delta, scale = _norm_case(shape, DTYPES[dtype], cuda, with_delta)
    before = fused.launches["add_rms_norm"]
    got_x, got_h = fused.add_rms_norm(x, delta, scale, EPS)
    want_x, want_h = ref.add_rms_norm_ref(x, delta, scale, EPS)
    torch.cuda.synchronize()
    assert fused.launches["add_rms_norm"] == before + 1
    assert torch.equal(got_x, want_x)          # rounded as the chain does
    if not with_delta:
        assert got_x is x
    _close(got_h, want_h)


# ------------------------------------------------------ RoPE + K/V write
def _rope_case(shape, dtype, device, with_deltas=False):
    """q, k, v of T rows, a third of them padding; pages with a scratch
    page last; the valid rows' (page, slot) pairs distinct, none in the
    scratch page."""
    _, h, hkv, d_head, _ = SHAPES[shape]
    gen = _gen(device, 2)
    t = ROWS[device.type]
    n_pages = -(-t // PAGE) + 4
    q = _randn((1, t, h, d_head), dtype, device, gen)
    k = _randn((1, t, hkv, d_head), dtype, device, gen)
    v = _randn((1, t, hkv, d_head), dtype, device, gen)
    pages = [_randn((n_pages + 1, PAGE, hkv, d_head), dtype, device, gen)
             for _ in range(2)]
    positions = torch.randint(0, 16384, (1, t), generator=gen,
                              device=device)
    sin, cos = layers.rope_freqs(positions, d_head, THETA)
    valid = torch.rand(t, generator=gen, device=device) < 0.65
    rows = torch.nonzero(valid).squeeze(1)
    dest = torch.randperm(n_pages * PAGE, generator=gen,
                          device=device)[:rows.numel()]
    deltas = ((_randn(q.shape, dtype, device, gen, 0.1),
               _randn(v.shape, dtype, device, gen, 0.1))
              if with_deltas else (None, None))
    return (q, k, v, sin, cos, *pages, rows, dest // PAGE,
            dest % PAGE), deltas


@pytest.mark.parametrize("with_deltas", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rope_write_kv_cpu_is_the_plain_composition(shape, dtype,
                                                    with_deltas):
    args, (dq, dv) = _rope_case(shape, DTYPES[dtype], torch.device("cpu"),
                                with_deltas)
    q, k, v, sin, cos, k_pages, v_pages, rows, pidx, slot = args
    # the paged model's composition before the kernel: attn_q/attn_kv's
    # RoPE, _add_deltas, _write_kv
    want_q = layers.apply_rope(q, sin, cos)
    want_k, want_v = layers.apply_rope(k, sin, cos), v
    if with_deltas:
        want_q = want_q + layers.apply_rope(dq, sin, cos)
        want_v = v + dv
    want_kp, want_vp = k_pages.clone(), v_pages.clone()
    want_kp[pidx, slot] = want_k[0][rows].to(want_kp.dtype)
    want_vp[pidx, slot] = want_v[0][rows].to(want_vp.dtype)
    for impl in ("kernel", "ref"):
        kp, vp, q_in = k_pages.clone(), v_pages.clone(), q.clone()
        got = kops.rope_write_kv(q_in, k, v, sin, cos, kp, vp, rows, pidx,
                                 slot, dq=dq, dv=dv, impl=impl)
        assert got is q_in and torch.equal(got, want_q)      # in place
        assert torch.equal(kp, want_kp) and torch.equal(vp, want_vp)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rope_write_kv_kernel(cuda, shape, dtype):
    args, _ = _rope_case(shape, DTYPES[dtype], cuda)
    q, k, v, sin, cos, k_pages, v_pages, rows, pidx, slot = args
    want_kp, want_vp = k_pages.clone(), v_pages.clone()
    want_q = ref.rope_write_kv_ref(q.clone(), k, v, sin, cos, want_kp,
                                       want_vp, rows, pidx, slot)
    kp, vp = k_pages.clone(), v_pages.clone()
    q_in = q.clone()
    before = fused.launches["rope_write_kv"]
    got_q = fused.rope_write_kv(q_in, k, v, sin, cos, kp, vp, rows, pidx,
                                slot)
    torch.cuda.synchronize()
    assert fused.launches["rope_write_kv"] == before + 1
    assert got_q.data_ptr() == q_in.data_ptr()          # roped in place
    assert torch.equal(got_q, want_q)
    assert torch.equal(kp, want_kp) and torch.equal(vp, want_vp)
    # no slot outside (pidx, slot) changed, the scratch page included
    written = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda)
    written[pidx, slot] = True
    assert not bool(written[-1].any())
    assert torch.equal(kp[~written], k_pages[~written])
    assert torch.equal(vp[~written], v_pages[~written])


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rope_write_kv_kernel_with_lora_deltas(cuda, shape, dtype):
    """The LoRA path on the card adds dq to q and dv to v, then takes the
    kernel: bit for bit the plain composition of (q + dq, v + dv).  The
    CPU's chain ropes q and dq apart and rounds each, so against it q is
    within rounding of its scale: one bf16 ulp of the largest |q|, or
    1e-6 of it in float32 (RoPE is linear); the pages are equal."""
    args, (dq, dv) = _rope_case(shape, DTYPES[dtype], cuda, True)
    q, k, v, sin, cos, k_pages, v_pages, rows, pidx, slot = args
    want_kp, want_vp = k_pages.clone(), v_pages.clone()
    want_q = ref.rope_write_kv_ref(q + dq, k, v + dv, sin, cos, want_kp,
                                   want_vp, rows, pidx, slot)
    chain_kp, chain_vp = k_pages.clone(), v_pages.clone()
    chain_q = ref.rope_write_kv_ref(q.clone(), k, v, sin, cos, chain_kp,
                                    chain_vp, rows, pidx, slot, dq, dv)
    kp, vp = k_pages.clone(), v_pages.clone()
    q_in = q.clone()
    before = fused.launches["rope_write_kv"]
    got_q = fused.rope_write_kv(q_in, k, v, sin, cos, kp, vp, rows, pidx,
                                slot, dq=dq, dv=dv)
    torch.cuda.synchronize()
    assert fused.launches["rope_write_kv"] == before + 1
    assert got_q.data_ptr() == q_in.data_ptr()
    assert torch.equal(got_q, want_q)
    assert torch.equal(kp, want_kp) and torch.equal(vp, want_vp)
    assert torch.equal(kp, chain_kp) and torch.equal(vp, chain_vp)
    top = chain_q.float().abs().max().item()
    tol = (2.0 ** (int(torch.tensor(top).log2().floor()) - 7)
           if dtype == "bfloat16" else 1e-6 * top)
    assert (got_q.float() - chain_q.float()).abs().max().item() <= tol


# ------------------------------------------------------ gated activation
def _act_case(shape, dtype, device):
    f = SHAPES[shape][4]
    gen = _gen(device, 3)
    t = ROWS[device.type]
    return (_randn((1, t, f), dtype, device, gen, 2.0),
            _randn((1, t, f), dtype, device, gen))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gated_act_cpu_is_the_plain_composition(shape, dtype, act):
    gate, up = _act_case(shape, DTYPES[dtype], torch.device("cpu"))
    want = layers.activation(act, gate) * up
    for impl in ("kernel", "ref"):
        assert torch.equal(kops.gated_act(gate, up, act, impl=impl), want)


@pytest.mark.chip
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gated_act_kernel(cuda, shape, dtype, act):
    gate, up = _act_case(shape, DTYPES[dtype], cuda)
    before = fused.launches["gated_act"]
    got = fused.gated_act(gate, up, act)
    want = ref.gated_act_ref(gate, up, act)
    torch.cuda.synchronize()
    assert fused.launches["gated_act"] == before + 1
    _close(got, want)


# ------------------------------------------------------ wrapper contracts
def test_fused_wrappers_refuse_autograd():
    x = torch.randn(2, 8, requires_grad=True)
    scale = torch.zeros(8)
    with pytest.raises(RuntimeError, match="no backward"):
        fused.add_rms_norm(x, None, scale, EPS)
    with pytest.raises(RuntimeError, match="no backward"):
        fused.gated_act(x, x, "silu")
    args, _ = _rope_case("qwen3-0.6b", torch.float32, torch.device("cpu"))
    q = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused.rope_write_kv(q, *args[1:])
    with torch.no_grad():
        fused.gated_act(x, x, "silu")


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_attention_writes_into_out(impl):
    """``out=`` of the decode and prefill attentions: the result lands in
    the given view, equal to a fresh call's."""
    gen = _gen(torch.device("cpu"), 4)
    b, s, h, hkv, d, nb = 2, 5, 4, 2, 16, 3
    kp = torch.randn((2 * nb + 1, 4, hkv, d), generator=gen)
    vp = torch.randn(kp.shape, generator=gen)
    bt = torch.arange(2 * nb, dtype=torch.int32).reshape(b, nb)
    q = torch.randn((b + b * s, h, d), generator=gen)
    o = torch.full_like(q, float("nan"))
    lengths = torch.tensor([7, 0], dtype=torch.int32)
    ctx, chunk = (torch.tensor([3, 0], dtype=torch.int32),
                  torch.tensor([5, 2], dtype=torch.int32))
    got_d = kops.paged_attention(q[:b], kp, vp, bt, lengths, out=o[:b],
                                 impl=impl)
    got_p = kops.paged_prefill(q[b:].view(b, s, h, d), kp, vp, bt, ctx,
                               chunk, out=o[b:].view(b, s, h, d), impl=impl)
    assert got_d.data_ptr() == o.data_ptr()
    assert got_p.data_ptr() == o[b:].data_ptr()
    assert torch.equal(o[:b], kops.paged_attention(q[:b], kp, vp, bt,
                                                   lengths, impl=impl))
    assert torch.equal(o[b:].view(b, s, h, d), kops.paged_prefill(
        q[b:].view(b, s, h, d), kp, vp, bt, ctx, chunk, impl=impl))
    with pytest.raises(ValueError, match="out must be"):
        kops.paged_attention(q[:b], kp, vp, bt, lengths, out=o[:1],
                             impl=impl)


# ------------------------------------------------------ in the paged step
def _mixed_args(cfg, device, dtype, gen):
    """Two decode rows and an idle one, two chunks (one partial, one
    idle) over distinct pages, a scratch page last."""
    n_pages, page = 24, 8
    shape = (cfg.n_layers, n_pages + 1, page, cfg.n_kv_heads, cfg.head_dim)
    pool = PM.PagePool(_randn(shape, dtype, device, gen),
                       _randn(shape, dtype, device, gen))

    def i32(rows):
        return torch.tensor(rows, dtype=torch.int32, device=device)
    args = (i32([5, 77, 0]), i32([13, 30, 0]),
            i32([[3, 7, 11, 2], [9, 1, 4, 8], [n_pages] * 4]),
            torch.tensor([True, True, False], device=device),
            torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                          device=device).to(torch.int32),
            i32([[15, 6, 20, 12], [n_pages] * 4]), i32([10, 0]),
            i32([11, 0]))
    return pool, args, page


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "glm4-9b"])
def test_mixed_step_launches_each_fused_kernel_per_layer(cuda, name, dtype):
    """One ``mixed_step`` of an n-layer config launches ``add_rms_norm``
    2n + 1 times (the first layer's norm, then two a layer: after the
    attention and after the FFN, the last into the final norm),
    ``rope_write_kv`` n times and ``gated_act`` n times for a dense
    config (none for MoE, whose experts keep their own activation); its
    logits and pool agree with the plain composition's on the card."""
    cfg = get_reduced_config(name)
    dtype = DTYPES[dtype]
    gen = _gen(cuda, 5)
    params = M.init(cfg, 0, dtype=dtype, device=cuda)
    pool, args, page = _mixed_args(cfg, cuda, dtype, gen)
    outs = {}
    for impl in ("kernel", "ref"):
        p = PM.PagePool(pool.k.clone(), pool.v.clone())
        before = dict(fused.launches)
        d, pre, p = PM.mixed_step(params, p, *args, cfg=cfg, page_size=page,
                                  impl=impl)
        torch.cuda.synchronize()
        counts = {k: fused.launches[k] - before[k] for k in before}
        outs[impl] = (torch.cat([d, pre]).float(), p)
        n = cfg.n_layers
        dense = "moe" not in M.layer_view(params["run_0"], 0)
        assert counts == ({"add_rms_norm": 2 * n + 1, "rope_write_kv": n,
                           "gated_act": n if dense else 0}
                          if impl == "kernel" else dict.fromkeys(counts, 0))
    (lk, pk), (lr, pr) = outs["kernel"], outs["ref"]
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    scale = lr.abs().max().item()
    assert (lk - lr).abs().max().item() <= tol * scale
    for a, b in ((pk.k, pr.k), (pk.v, pr.v)):
        assert (a.float() - b.float()).abs().max().item() \
            <= tol * b.float().abs().max().item()
