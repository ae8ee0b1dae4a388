"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes with ragged edges (the full-width shapes run in
chip_smoke.py).  Marked ``cuda``: they skip without a card.  On a machine
with the card and no JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from neuroclear_tpu_torch.ops import conv3x3, inorm, wconv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape, cin", [((1, 3, 5, 6), 64), ((2, 4, 3, 10), 128),
                                        ((1, 5, 7, 10), 64), ((1, 2, 2, 4), 128)])
def test_wconv_kernel_matches_plain(dev, shape, cin):
    g = torch.Generator(device="cpu").manual_seed(cin + shape[-1])
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(64, cin, 3, 3, 3, generator=g) * math.sqrt(2.0 / (27 * cin))
    b = torch.randn(64, generator=g).to(dev)
    wt = wconv.pack_weight(w.to(dev, torch.bfloat16))
    before = wconv.conv3d.launches
    y = wconv.conv3d(x, wt, b)
    torch.cuda.synchronize()
    assert wconv.conv3d.launches == before + 1
    p = wconv.conv3d_plain(x, wt, b).float()
    # one bf16 rounding of f32 sums taken in another order
    tol = 2.0 ** -7 * p.abs() + 2.0 ** -12 * p.abs().max()
    assert ((y.float() - p).abs() <= tol).all()


def _bf16_step_tol(p: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding of f32 sums taken in another order."""
    return 2.0 ** -7 * p.abs() + 2.0 ** -12 * p.abs().max()


@pytest.mark.parametrize("shape, cin", [((1, 3, 5, 6), 64), ((2, 4, 3, 10), 128),
                                        ((1, 5, 7, 10), 128), ((1, 2, 2, 4), 64)])
def test_wconv_dx_kernel_matches_plain(dev, shape, cin):
    """The input gradient: the conv kernel with 64 or 128 output channels,
    no bias, in one launch."""
    g = torch.Generator(device="cpu").manual_seed(cin + shape[-1] + 1)
    gy = torch.randn(*shape, 64, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(64, cin, 3, 3, 3, generator=g) * math.sqrt(2.0 / (27 * cin))
    wt = wconv.pack_weight(w.to(dev, torch.bfloat16))
    before = wconv.conv3d_dx.launches
    dx = wconv.conv3d_dx(gy, wt)
    torch.cuda.synchronize()
    assert wconv.conv3d_dx.launches == before + 1 and dx.shape == (*shape, cin)
    p = wconv.conv3d_dx_plain(gy, wt).float()
    assert ((dx.float() - p).abs() <= _bf16_step_tol(p)).all()


@pytest.mark.parametrize("shape, cin", [((1, 3, 5, 6), 64), ((2, 4, 3, 10), 128),
                                        ((1, 9, 11, 12), 64), ((1, 2, 2, 4), 128)])
def test_wconv_dw_kernel_matches_plain(dev, shape, cin):
    """The weight gradient, f32 out, against the plain f32 sums: f32 sums of
    the same bf16 products in another order, within 1e-5 of the sum of the
    products' magnitudes."""
    g = torch.Generator(device="cpu").manual_seed(cin + shape[-1] + 2)
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    gy = torch.randn(*shape, 64, generator=g).to(dev, torch.bfloat16)
    before = wconv.conv3d_dw.launches
    dw = wconv.conv3d_dw(x, gy)
    torch.cuda.synchronize()
    assert wconv.conv3d_dw.launches == before + 1
    assert dw.dtype == torch.float32 and dw.shape == (27, 64, cin)
    p = wconv.conv3d_dw_plain(x, gy)
    mag = wconv.conv3d_dw_plain(x.abs(), gy.abs())
    assert ((dw - p).abs() <= 1e-5 * mag + 1e-6).all()


def test_wconv_autograd_function_on_the_card(dev):
    """WConvFn's three gradients through the kernels against the same
    Function on the plain versions."""
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(1, 4, 6, 8, 128, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(64, 128, 3, 3, 3, generator=g) * 0.03).to(dev)
    b = torch.randn(64, generator=g).to(dev)
    gy = torch.randn(1, 4, 6, 8, 64, generator=g).to(dev, torch.bfloat16)
    grads = []
    for plain in (False, True):
        xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = wconv.WConvFn.apply(xr, wconv.pack_weight(wr.to(torch.bfloat16)), br, plain)
        y.backward(gy)
        grads.append((y.float(), xr.grad.float(), wr.grad, br.grad))
    for k, p in zip(grads[0], grads[1]):
        assert ((k - p).abs() <= _bf16_step_tol(p)).all()


@pytest.mark.parametrize("shape, cin, cout", [((1, 3, 5, 7), 32, 32), ((2, 4, 3, 10), 64, 128),
                                              ((1, 5, 7, 33), 96, 96), ((1, 2, 2, 3), 256, 64),
                                              ((1, 6, 4, 32), 128, 128)])
def test_conv3x3_kernel_matches_plain(dev, shape, cin, cout):
    """The dense-K conv, every cout template, ragged voxel counts: one bf16
    rounding of f32 sums taken in another order."""
    g = torch.Generator(device="cpu").manual_seed(cin + cout + shape[-1])
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(cout, cin, 3, 3, 3, generator=g) * math.sqrt(2.0 / (27 * cin))
    b = torch.randn(cout, generator=g).to(dev)
    wt = wconv.pack_weight(w.to(dev, torch.bfloat16))
    before = conv3x3.conv3d.launches
    y = conv3x3.conv3d(x, wt, b)
    torch.cuda.synchronize()
    assert conv3x3.conv3d.launches == before + 1 and y.shape == (*shape, cout)
    p = conv3x3.conv3d_plain(x, wt, b).float()
    assert ((y.float() - p).abs() <= _bf16_step_tol(p)).all()


def test_conv3x3_autograd_function_on_the_card(dev):
    """Conv3x3Fn through the kernel against the same Function on the plain
    version: the forward to one bf16 step; the gradients, PyTorch's conv
    gradients on both sides of the same operands, to one bf16 step of a sum
    order cuDNN may choose anew."""
    g = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn(1, 4, 6, 32, 64, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(128, 64, 3, 3, 3, generator=g) * 0.03).to(dev)
    b = torch.randn(128, generator=g).to(dev)
    gy = torch.randn(1, 4, 6, 32, 128, generator=g).to(dev, torch.bfloat16)
    outs = []
    for plain in (False, True):
        xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = conv3x3.Conv3x3Fn.apply(xr, wconv.pack_weight(wr.to(torch.bfloat16)), br, plain)
        y.backward(gy)
        outs.append((y.float(), xr.grad, wr.grad, br.grad))
    for k, p in zip(outs[0], outs[1]):
        assert ((k.float() - p.float()).abs() <= _bf16_step_tol(p.float())).all()


# Shapes that cut the kernels' TMA boxes at every face: D of 1 and 2, H and W
# not multiples of any box extent, W under the box's x extent, batch 2.
RAGGED = [(1, 1, 9, 17), (2, 2, 7, 5), (1, 3, 13, 19), (2, 5, 6, 40), (1, 4, 9, 20)]


@pytest.mark.parametrize("shape, cin, cout", [
    (RAGGED[0], 64, 64), (RAGGED[1], 32, 96), (RAGGED[2], 96, 128), (RAGGED[3], 32, 32),
    (RAGGED[4], 96, 64), (RAGGED[1], 192, 128), (RAGGED[0], 256, 96)])
def test_conv3x3_kernel_ragged_boxes(dev, shape, cin, cout):
    """The conv on boxes cut at every face; cin 32, 96 and 192 take 32-channel
    stages under the 64-byte swizzle, the others 64-channel ones."""
    g = torch.Generator(device="cpu").manual_seed(cin * cout + sum(shape))
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(cout, cin, 3, 3, 3, generator=g) * math.sqrt(2.0 / (27 * cin))
    b = torch.randn(cout, generator=g).to(dev)
    wt = wconv.pack_weight(w.to(dev, torch.bfloat16))
    y = conv3x3.conv3d(x, wt, b)
    torch.cuda.synchronize()
    p = conv3x3.conv3d_plain(x, wt, b).float()
    assert ((y.float() - p).abs() <= _bf16_step_tol(p)).all()


@pytest.mark.parametrize("shape, cin", [(RAGGED[0], 64), (RAGGED[1], 128), (RAGGED[2], 64)])
def test_wconv_dx_kernel_ragged_boxes(dev, shape, cin):
    g = torch.Generator(device="cpu").manual_seed(cin + sum(shape) + 7)
    gy = torch.randn(*shape, 64, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(64, cin, 3, 3, 3, generator=g) * math.sqrt(2.0 / (27 * cin))
    wt = wconv.pack_weight(w.to(dev, torch.bfloat16))
    dx = wconv.conv3d_dx(gy, wt)
    torch.cuda.synchronize()
    p = wconv.conv3d_dx_plain(gy, wt).float()
    assert ((dx.float() - p).abs() <= _bf16_step_tol(p)).all()


@pytest.mark.parametrize("shape, cin", [(RAGGED[0], 128), (RAGGED[1], 64), (RAGGED[3], 64),
                                        ((1, 19, 23, 52), 64), ((1, 19, 23, 52), 128)])
def test_wconv_dw_kernel_ragged_boxes_and_chunks(dev, shape, cin):
    """dw on boxes cut at every face and, at (1, 19, 23, 52), split into
    chunks that start and end inside rows and planes of boxes; bitwise the
    same on a second run."""
    plan = wconv.dw_plan(shape, cin)
    g = torch.Generator(device="cpu").manual_seed(cin + sum(shape) + 8)
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    gy = torch.randn(*shape, 64, generator=g).to(dev, torch.bfloat16)
    dw = wconv.conv3d_dw(x, gy)
    torch.cuda.synchronize()
    p = wconv.conv3d_dw_plain(x, gy)
    mag = wconv.conv3d_dw_plain(x.abs(), gy.abs())
    assert ((dw - p).abs() <= 1e-5 * mag + 1e-6).all()
    assert torch.equal(dw, wconv.conv3d_dw(x, gy))
    if shape == (1, 19, 23, 52):
        assert plan.chunks > 1 and plan.per_chunk % plan.counts[2] and plan.nboxes % plan.per_chunk


def test_wrappers_refuse_misaligned_views_on_the_card(dev):
    """A contiguous view 2 bytes into its storage: no TMA map, no launch."""
    buf = torch.zeros(2 * 4 * 6 * 8 * 64 + 8, dtype=torch.bfloat16, device=dev)
    x = buf[1:1 + 2 * 4 * 6 * 8 * 64].view(2, 4, 6, 8, 64)
    wt = torch.zeros((27, 64, 64), dtype=torch.bfloat16, device=dev)
    before = (conv3x3.conv3d.launches, wconv.conv3d_dw.launches, wconv.conv3d.launches)
    with pytest.raises(ValueError):
        conv3x3.conv3d(x, wt, None)
    with pytest.raises(ValueError):
        wconv.conv3d(x, wt, torch.zeros(64, device=dev))
    with pytest.raises(ValueError):
        wconv.conv3d_dw(x, torch.zeros((2, 4, 6, 8, 64), dtype=torch.bfloat16, device=dev))
    assert (conv3x3.conv3d.launches, wconv.conv3d_dw.launches, wconv.conv3d.launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 7, 64), (2, 1000, 128), (3, 333, 256), (1, 5, 8),
                                   (1, 144, 512)])
@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_inorm_backward_kernels_match_plain(dev, dtype, shape, act):
    """pair_sums_gy within 1e-5 of f64 sums of magnitudes; bwd_map and the
    map, with and without the pre-activation kept, bit-equal to their plain
    versions."""
    g = torch.Generator(device="cpu").manual_seed(shape[1] + 3)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(dev, dtype)
    gy = torch.randn(*shape, generator=g).to(dev, dtype)
    _, scale, shift = inorm.pair_sums(x)
    pre, y = inorm.affine_map_act(x, scale, shift, act, keep_pre=True)
    pre_p, y_p = inorm.affine_map_act_plain(x, scale, shift, act, keep_pre=True)
    assert torch.equal(pre, pre_p) and torch.equal(y, y_p)
    assert torch.equal(inorm.affine_map_act(x, scale, shift, act), y_p)
    s, mg, mgy = inorm.pair_sums_gy(gy, pre, act)
    gd = inorm.act_grad_plain(gy.double(), pre.double(), act)
    ref = torch.stack([gd.sum(1), (gd * pre.double()).sum(1)], 1)
    mag = torch.stack([gd.abs().sum(1), (gd * pre.double()).abs().sum(1)], 1)
    assert ((s.double() - ref).abs() <= 1e-5 * mag + 1e-30).all()
    dx = inorm.bwd_map(gy, pre, scale, mg, mgy, act)
    assert torch.equal(dx, inorm.bwd_map_plain(gy, pre, scale, mg, mgy, act))


@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_instance_norm_function_on_the_card(dev, act):
    """InstanceNormFn through the kernels against the same Function on the
    plain versions, f32: the forward bit-equal, the input gradient to f32
    rounding of sums taken in another order."""
    g = torch.Generator(device="cpu").manual_seed(9)
    x = (torch.randn(2, 6, 5, 4, 128, generator=g) * 3 + 1).to(dev)
    gy = torch.randn(2, 6, 5, 4, 128, generator=g).to(dev)
    outs = []
    for plain in (False, True):
        xr = x.clone().requires_grad_(True)
        y = inorm.InstanceNormFn.apply(xr, act, plain)
        y.backward(gy)
        outs.append((y, xr.grad))
    assert torch.allclose(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    assert torch.allclose(outs[0][1], outs[1][1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 7, 64), (2, 1000, 128), (3, 333, 256), (1, 5, 8)])
def test_inorm_kernels_match_plain(dev, dtype, shape):
    g = torch.Generator(device="cpu").manual_seed(shape[1])
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(dev, dtype)
    s, scale, shift = inorm.pair_sums(x)
    xd = x.double()
    ref = torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)
    mag = torch.stack([xd.abs().sum(1), (xd * xd).sum(1)], 1)
    assert ((s.double() - ref).abs() <= 1e-5 * mag).all()
    for act in (None, "relu"):
        y = inorm.affine_map_act(x, scale, shift, act)
        assert torch.equal(y, inorm.affine_map_act_plain(x, scale, shift, act))


def _within_f32_ulp(k: torch.Tensor, p: torch.Tensor, ulps: int) -> bool:
    """Every element of k within ``ulps`` f32 units in the last place of p's
    (or k's, the larger) magnitude."""
    m = torch.maximum(k.abs(), p.abs())
    _, e = torch.frexp(m)
    ulp = torch.ldexp(torch.ones_like(m), e - 24)  # f32: 24 significant bits
    return bool(((k - p).abs() <= ulps * ulp).all())


def _stats_inputs(shape, dtype, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(dev, dtype)
    gy = torch.randn(*shape, generator=g).to(dev, dtype)
    return x, gy


def _check_stats(fn, args, sums_ref, mag, glue):
    """One launch; the sums within 1e-5 of the f64 sums of magnitudes; the
    coefficients within 2 f32 ulp of the PyTorch glue on the kernel's own
    sums; a second call bit-equal."""
    before = fn.launches
    s, c0, c1 = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    n, _, c = s.shape
    assert c0.shape == c1.shape == (n, c) and c0.is_contiguous() and c1.is_contiguous()
    assert ((s.double() - sums_ref).abs() <= 1e-5 * mag + 1e-30).all()
    r0, r1 = glue(s)
    assert _within_f32_ulp(c0, r0, 2) and _within_f32_ulp(c1, r1, 2)
    again = fn(*args)
    assert all(torch.equal(a, b) for a, b in zip((s, c0, c1), again))
    return s, c0, c1


# The discriminators' norms of a 108^3 step, the earlier card shapes, one that
# streams in many chunks, R = 1, and the widest C of each dtype (C / V = 256)
# read whole by one block per slab and in chunks
STATS_SHAPES = [(1, 27 ** 2, 128), (1, 13 ** 2, 256), (1, 12 ** 2, 512), (1, 7, 64),
                (2, 1000, 128), (3, 333, 256), (1, 5, 8), (1, 300_000, 64), (1, 1, 64),
                ("widest", 700), ("widest", 40_000)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", STATS_SHAPES)
@pytest.mark.parametrize("form", [None, "gy", "gy relu", "gy leaky"])
def test_stats_kernel_one_launch(dev, dtype, shape, form):
    """pair_sums (form None) and pair_sums_gy: sums, coefficients and a
    bit-equal second call, each call one launch."""
    if shape[0] == "widest":
        shape = (1, shape[1], 256 * 16 // torch.empty((), dtype=dtype).element_size())
    x, gy = _stats_inputs(shape, dtype, shape[1] + shape[2], dev)
    rows = shape[1]
    if form is None:
        xd = x.double()
        ref = torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)
        mag = torch.stack([xd.abs().sum(1), (xd * xd).sum(1)], 1)
        plan = inorm.stats_plan(*shape, x.element_size())
        _check_stats(inorm.pair_sums, (x,), ref, mag,
                     lambda s: inorm.norm_coefficients(s, rows))
    else:
        act = None if form == "gy" else form.split()[1]
        gd = inorm.act_grad_plain(gy.double(), x.double(), act)
        ref = torch.stack([gd.sum(1), (gd * x.double()).sum(1)], 1)
        mag = torch.stack([gd.abs().sum(1), (gd * x.double()).abs().sum(1)], 1)
        plan = inorm.stats_plan(*shape, x.element_size())
        _check_stats(inorm.pair_sums_gy, (gy, x, act), ref, mag,
                     lambda s: inorm.sum_means(s, rows))
    if shape[1] >= 40_000:
        assert plan.chunks > 1  # the cross-block step ran


def test_stats_kernel_restores_its_tickets(dev):
    """Calls at alternating shapes, in several chunks of different counts and
    in one, stay right: each launch leaves its counters at zero for the
    next."""
    shapes = [(1, 300_000, 64), (2, 50_000, 128), (1, 729, 128), (1, 120_000, 64)]
    calls = []
    for shape in shapes:
        x, gy = _stats_inputs(shape, torch.bfloat16, shape[1], dev)
        ref = inorm.pair_sums(x)
        ref_gy = inorm.pair_sums_gy(gy, x, "relu")
        calls.append((x, gy, ref, ref_gy))
    assert sum(inorm.stats_plan(*s, 2).chunks > 1 for s in shapes) == 3
    for _ in range(3):
        for x, gy, ref, ref_gy in calls:
            xd = x.double()
            got = inorm.pair_sums(x)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
            assert ((got[0][:, 0].double() - xd.sum(1)).abs()
                    <= 1e-5 * xd.abs().sum(1)).all()
            assert all(torch.equal(a, b) for a, b in zip(inorm.pair_sums_gy(gy, x, "relu"),
                                                         ref_gy))
    assert int(inorm._tickets(dev).abs().sum()) == 0


def _device_operations(fn) -> list:
    """The device operations one call of ``fn`` runs, by torch.profiler:
    [(name, count)]."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


@pytest.mark.parametrize("shape", [(1, 20, 20, 20, 64), (1, 12, 12, 512)])
def test_instance_norm_is_two_launches_each_way(dev, shape):
    """On the kernel path a norm's forward is the statistics and the map, and
    its backward the statistics and the map: two device operations each way,
    with no PyTorch operation between them (in several chunks with tickets,
    and in one)."""
    g = torch.Generator(device="cpu").manual_seed(13)
    x = torch.randn(*shape, generator=g).to(dev, torch.bfloat16).requires_grad_(True)
    gy = torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
    n, c = shape[0], shape[-1]
    assert (inorm.stats_plan(n, x.numel() // (n * c), c, 2).chunks > 1) == (c == 64)
    inorm.instance_norm_act(x, "relu").backward(gy)  # builds and allocates once
    x.grad = None
    out = []
    fwd = _device_operations(lambda: out.append(inorm.instance_norm_act(x, "relu")))
    bwd = _device_operations(lambda: out[0].backward(gy))
    assert sum(k for _, k in fwd) == 2 and sum(k for _, k in bwd) == 2, (fwd, bwd)
    assert all("pair_sums_kernel" in name or "map" in name for name, _ in fwd + bwd)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((1, 4, 4, 6, 64), dtype=torch.float32, device=dev)
    wt = torch.zeros((27, 64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):
        wconv.conv3d(x, wt, torch.zeros(64, device=dev))       # f32 input
    with pytest.raises(ValueError):
        inorm.pair_sums(torch.zeros((1, 10, 12), device=dev))  # C = 12
    before = conv3x3.conv3d.launches
    with pytest.raises(ValueError):                            # cout 160
        conv3x3.conv3d(x.to(torch.bfloat16), torch.zeros((27, 160, 64), dtype=torch.bfloat16,
                                                         device=dev))
    assert conv3x3.conv3d.launches == before


@pytest.mark.parametrize("c", [64, 128])
def test_f32_norm_kernels_at_the_per_cube_shape(dev, c):
    """The per-cube loop's norms: batch 1, one 140^3 cube, f32.  The sums
    within 1e-5 of the f64 sums of magnitudes (one launch, the coefficients
    within 2 f32 ulp of the glue, a second call bit-equal), the map equal to
    its plain version."""
    x, _ = _stats_inputs((1, 140 ** 3, c), torch.float32, c, dev)
    xd = x.double()
    ref = torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)
    mag = torch.stack([xd.abs().sum(1), (xd * xd).sum(1)], 1)
    del xd
    _, scale, shift = _check_stats(inorm.pair_sums, (x,), ref, mag,
                                   lambda s: inorm.norm_coefficients(s, 140 ** 3))
    before = inorm.affine_map_act.launches
    y = inorm.affine_map_act(x, scale, shift, "relu")
    assert inorm.affine_map_act.launches == before + 1
    assert torch.equal(y, inorm.affine_map_act_plain(x, scale, shift, "relu"))


def test_run_matches_run_streaming_on_the_card(dev):
    """The non-streaming entry point against the streaming one on the
    kernels (bf16, real UNetDeconv weights): one pipeline, so the launches
    are run_streaming's (ten norms per tile batch, batches within a z-slab)
    and the volumes are equal, bit for bit."""
    import numpy as np

    from neuroclear_tpu_torch.data.dicing import DiceGrid
    from neuroclear_tpu_torch.nn.generators import UNetDeconv
    from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
    from neuroclear_tpu_torch.utils.imageops import pad_for_dicing
    from neuroclear_tpu_torch.utils.weights import init_flat, params_from_numpy

    vol = np.random.default_rng(2).integers(0, 65535, (70, 60, 50)).astype(np.uint16)
    vp = pad_for_dicing(vol, 32, 8)
    net = UNetDeconv(1, 1)
    net.load_state_dict(params_from_numpy(init_flat(net, seed=3), net))
    net.to(dev).eval()
    pipe = DiceInferencePipeline(net, DiceGrid(vp.shape, 32, 8, 4), 1 / 65535.0, tile_batch=2,
                                 precision="bfloat16", out_dtype=np.uint16, orig_shape=vol.shape,
                                 device=dev)
    before = inorm.pair_sums.launches
    out = pipe.run(vp)
    g = pipe.grid
    batches = g.z_steps * -(-(g.y_steps * g.x_steps) // 2)
    assert inorm.pair_sums.launches == before + 10 * batches
    assert out.shape == vol.shape and out.std() > 0
    assert np.array_equal(out, pipe.run_streaming(vp))


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_step_on_the_card_is_bitwise_and_counts_its_recomputations(dev, accum):
    """The Apollo step at 24^3 in bf16 on the kernels, with --remat and
    without, from the same weights, crops and draws: parameters and losses
    bitwise equal (the kernels replay the same bits when recomputed, the
    statistics kernel's tickets included), and the launches per crop those
    of chip_smoke.py's tables."""
    import chip_smoke as cs
    from neuroclear_tpu_torch import ops
    from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import ApolloModel
    from neuroclear_tpu_torch.options import train_options

    runs = {}
    for remat in (False, True):
        argv = ["--dataroot", "unused", "--gan_mode", "lsgan", "--precision", "bfloat16",
                "--randomize_projection_depth", "--projection_depth", "4"]
        model = ApolloModel(train_options.build_parser().parse_args(
            argv + (["--remat"] if remat else [])), dev)
        model.init_weights(2)
        gen = torch.Generator().manual_seed(3)
        crops = [torch.rand((1, 24, 24, 24, 1), generator=gen).to(dev) for _ in range(accum)]
        draws = model.draw_probes((24,) * 3, gen)
        ops.reset_launches()
        losses, _, _ = model.optimize_parameters_accum(lambda i: crops[i], accum, draws)
        torch.cuda.synchronize()
        table = cs.REMAT_STEP_LAUNCHES if remat else cs.STEP_LAUNCHES
        assert ops.launches() == {k: accum * v for k, v in table.items()}
        runs[remat] = (losses, [p.detach().clone() for p in model.g_params + model.d_params])
    (la, pa), (lb, pb) = runs[False], runs[True]
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert all(torch.equal(p, q) for p, q in zip(pa, pb))
