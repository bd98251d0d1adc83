"""The narrow 3-D weight gradient on the CPU: its plain version, its
autograd function, its routing and its wrapper.

``ops/conv3d_wgrad.py`` gives ``ConvBN3d`` a weight gradient computed by
a hand-written kernel (``csrc/conv3d_wgrad.cu``) where the convolution is
narrow and runs in fp32 on the card; the card alone runs the kernel.
Here:

- the plain version against float64 ``torch.nn.grad.conv3d_weight`` over
  the five families of SlowFast's narrow convolutions and odd sizes
  (ragged tiles, padding, strides), in NCDHW and NDHWC strides, dW in the
  weight's memory format;
- ``gradcheck`` of ``NarrowWgradConv3d`` in float64 on the plain path;
- the routing predicate, which takes no grouped, dilated, bf16, biased
  or wide convolution and nothing on the CPU;
- ``ConvBN3d``'s parameter names and ``state_dict``, unchanged;
- the kernel's plan: its contract with the kernel (coverage, the staged
  window, shared memory, threads) at the cell's shapes and odd ones, and
  every output position taken once, walked as the kernel walks it;
- the wrapper on a recording library: the geometry it passes, read back
  through the strides, gives the plain version's dW, and a launch counts
  on the wrapper and on the program counter.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from vfs_tpu_torch.models.backbones.resnet3d import ConvBN3d
from vfs_tpu_torch.ops import _build, conv3d_wgrad
from vfs_tpu_torch.ops.conv3d_wgrad import (CO_TILE, MAX_THREADS,
                                            SMEM_BLOCK, NarrowWgradConv3d,
                                            Sizes, Tiling, conv3d_weight,
                                            conv3d_weight_reference, narrow,
                                            narrow_shape, plan, takes)
from vfs_tpu_torch.utils import trace

# (X shape (N, Cin, T, H, W), weight shape, stride, padding): the five
# families of SlowFast-R50's narrow convolutions at small sizes (the fast
# stem 5x7x7 3->8 stride (1, 2, 2); 1x1x1 8->32; 1x3x3 8->8; 3x1x1 8->8;
# the slow stem 1x7x7 3->64), then odd sizes: a lateral's temporal stride
# 8, a strided 1x3x3, a strided 1x1x1, a map narrower than the window,
# odd channel counts
CASES = [
    ((2, 3, 6, 20, 22), (8, 3, 5, 7, 7), (1, 2, 2), (2, 3, 3)),
    ((2, 8, 4, 9, 7), (32, 8, 1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ((2, 8, 4, 9, 7), (8, 8, 1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ((2, 8, 5, 6, 7), (8, 8, 3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ((2, 3, 3, 17, 15), (64, 3, 1, 7, 7), (1, 2, 2), (0, 3, 3)),
    ((1, 8, 16, 3, 4), (16, 8, 5, 1, 1), (8, 1, 1), (2, 0, 0)),
    ((1, 16, 2, 7, 9), (16, 16, 1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((1, 4, 2, 7, 7), (8, 4, 1, 1, 1), (1, 2, 2), (0, 0, 0)),
    ((1, 3, 2, 3, 4), (8, 3, 5, 7, 7), (1, 2, 2), (2, 3, 3)),
    ((2, 5, 3, 5, 6), (24, 5, 3, 1, 1), (1, 1, 1), (1, 0, 0)),
]
LAYOUTS = ('ncdhw', 'ndhwc')

# train_slowfast_r50's routed shapes (chip_smoke.slowfast_conv_shapes)
CELL_SHAPES = [
    ((32, 3, 32, 224, 224), (8, 3, 5, 7, 7), (1, 2, 2), (2, 3, 3)),
    ((32, 3, 4, 224, 224), (64, 3, 1, 7, 7), (1, 2, 2), (0, 3, 3)),
    ((32, 8, 32, 56, 56), (32, 8, 1, 1, 1), (1, 1, 1), (0, 0, 0)),
    ((32, 8, 32, 56, 56), (8, 8, 1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ((32, 8, 32, 56, 56), (8, 8, 3, 1, 1), (1, 1, 1), (1, 0, 0)),
    ((32, 8, 32, 56, 56), (16, 8, 5, 1, 1), (8, 1, 1), (2, 0, 0)),
    ((32, 32, 32, 56, 56), (64, 32, 1, 1, 1), (1, 2, 2), (0, 0, 0)),
    ((32, 64, 4, 56, 56), (64, 64, 1, 3, 3), (1, 1, 1), (0, 1, 1)),
    ((32, 64, 32, 14, 14), (64, 64, 1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((32, 256, 4, 56, 56), (64, 256, 1, 1, 1), (1, 1, 1), (0, 0, 0)),
]


def inputs(case, layout, dtype=torch.float64, seed=0):
    x_shape, w_shape, stride, padding = case
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(x_shape, generator=g, dtype=dtype)
    weight = torch.randn(w_shape, generator=g, dtype=dtype)
    grad_out = torch.randn(F.conv3d(x, weight, None, stride, padding).shape,
                           generator=g, dtype=dtype)
    if layout == 'ndhwc':
        fmt = torch.channels_last_3d
        x, weight, grad_out = (t.contiguous(memory_format=fmt)
                               for t in (x, weight, grad_out))
    return x, grad_out, weight


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('case', CASES)
def test_plain_weight_gradient_matches_float64(case, layout):
    """The plain version is the weight gradient: float64 to the last few
    ulps of the largest entry, float32 within its rounding; dW keeps the
    weight's memory format."""
    _, w_shape, stride, padding = case
    x, grad_out, weight = inputs(case, layout)
    exact = torch.nn.grad.conv3d_weight(x, w_shape, grad_out, stride,
                                        padding)
    got = conv3d_weight(x, grad_out, weight, stride, padding)
    assert got.shape == weight.shape and got.stride() == weight.stride()
    scale = exact.abs().max()
    assert (got - exact).abs().max() <= 1e-12 * scale
    x32, g32, w32 = (t.float() for t in (x, grad_out, weight))
    got32 = conv3d_weight_reference(x32, g32, w32, stride, padding)
    assert got32.dtype == torch.float32
    assert (got32.double() - exact).abs().max() <= 1e-5 * scale


@pytest.mark.parametrize('needs', [(True, True), (False, True),
                                   (True, False)])
def test_function_gradcheck_float64(needs):
    """``NarrowWgradConv3d``'s forward is ``F.conv3d`` and its backward
    the data gradient and the plain weight gradient, for each input that
    wants one."""
    case = ((1, 3, 4, 7, 8), (8, 3, 3, 3, 3), (1, 2, 2), (1, 1, 1))
    x, _, weight = inputs(case, 'ndhwc')
    x.requires_grad_(needs[0])
    weight.requires_grad_(needs[1])
    out = NarrowWgradConv3d.apply(x, weight, case[2], case[3])
    assert torch.equal(out, F.conv3d(x, weight, None, case[2], case[3]))
    assert torch.autograd.gradcheck(
        lambda a, b: NarrowWgradConv3d.apply(a, b, case[2], case[3]),
        (x, weight))


def test_function_matches_conv3d_autograd():
    """Through ``NarrowWgradConv3d`` both gradients equal the ones
    PyTorch's own convolution gives, in float64."""
    case = CASES[0]
    x, grad_out, weight = inputs(case, 'ncdhw', seed=3)
    a = [t.clone().requires_grad_() for t in (x, weight)]
    b = [t.clone().requires_grad_() for t in (x, weight)]
    NarrowWgradConv3d.apply(*a, case[2], case[3]).backward(grad_out)
    F.conv3d(*b, None, case[2], case[3]).backward(grad_out)
    for mine, theirs in zip(a, b):
        assert torch.allclose(mine.grad, theirs.grad, rtol=1e-12,
                              atol=1e-12)


def conv(cin, cout, kernel, stride=1, padding=0, **kw):
    return nn.Conv3d(cin, cout, kernel, stride, padding, bias=False, **kw)


@pytest.mark.parametrize('module', [
    conv(3, 8, (5, 7, 7), (1, 2, 2), (2, 3, 3)),     # fast stem
    conv(8, 32, 1),                                  # fast res2 1x1x1
    conv(8, 8, (1, 3, 3), 1, (0, 1, 1)),             # fast res2 1x3x3
    conv(8, 8, (3, 1, 1), 1, (1, 0, 0)),             # fast res2 3x1x1
    conv(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3)),    # slow stem
    conv(8, 16, (5, 1, 1), (8, 1, 1), (2, 0, 0)),    # lateral 0
    conv(32, 8, (3, 1, 1), 1, (1, 0, 0)),            # fast res2 32->8
    conv(64, 64, (1, 3, 3), 1, (0, 1, 1)),           # slow res2 1x3x3
    conv(256, 64, 1),                                # slow res2 256->64
])
def test_narrow_takes_the_families(module):
    """The five families of the table and the laterals and 32->8
    convolutions the A/B put under the rule."""
    assert narrow(module, torch.float32)


@pytest.mark.parametrize('module,dtype', [
    (conv(8, 8, (1, 3, 3), 1, (0, 1, 1), groups=2), torch.float32),
    (conv(8, 8, (1, 3, 3), 1, (0, 2, 2), dilation=(1, 2, 2)), torch.float32),
    (conv(8, 8, (1, 3, 3), 1, (0, 1, 1)), torch.bfloat16),
    (conv(8, 8, (1, 3, 3), 1, (0, 1, 1)).to(torch.bfloat16), torch.float32),
    (conv(8, 8, (1, 3, 3), 1, (0, 1, 1)), torch.float64),
    (conv(128, 128, (1, 3, 3), 1, (0, 1, 1)), torch.float32),   # wide
    (conv(320, 128, 1), torch.float32),                         # wide
    (conv(128, 256, (5, 1, 1), (8, 1, 1), (2, 0, 0)), torch.float32),
    (nn.Conv3d(8, 8, (1, 3, 3), 1, (0, 1, 1), bias=True), torch.float32),
    (conv(8, 8, (1, 5, 5), 1, (0, 2, 2)), torch.float32),       # KW 5
    (conv(8, 8, (1, 3, 3), (1, 3, 3), (0, 1, 1)), torch.float32),
    (conv(8, 12, 1), torch.float32),                # Cout not 8k
    (nn.Conv3d(8, 8, 3, padding='same', bias=False), torch.float32),
    (nn.Conv3d(8, 8, 3, padding=1, bias=False, padding_mode='reflect'),
     torch.float32),
])
def test_narrow_rejects(module, dtype):
    """Grouped, dilated, non-fp32, biased, wide, unbuilt tap widths or
    strides, Cout off a multiple of 8, non-zero padding modes."""
    assert not narrow(module, dtype)


def test_shape_rule():
    assert narrow_shape(3, 8, (5, 7, 7)) and narrow_shape(64, 64, (1, 3, 3))
    assert narrow_shape(256, 64, (1, 1, 1)) and narrow_shape(128, 256, (1,))
    assert not narrow_shape(128, 128, (1, 3, 3))
    assert not narrow_shape(256, 64, (3, 1, 1))


def test_takes_nothing_on_the_cpu_or_without_a_gradient():
    """The predicate needs a CUDA input, gradients on and a weight that
    wants one; on the CPU ``conv3d`` is the module's own forward."""
    module = conv(8, 8, (1, 3, 3), 1, (0, 1, 1))
    x = torch.randn(1, 8, 2, 5, 5)
    assert narrow(module, x.dtype) and not takes(module, x)
    out = conv3d_wgrad.conv3d(module, x)
    assert out.grad_fn is not None
    assert 'NarrowWgradConv3d' not in type(out.grad_fn).__name__
    assert torch.equal(out, module(x))
    meta = torch.empty(1, 8, 2, 5, 5, device='meta')
    assert not takes(module, meta)
    with torch.no_grad():
        assert not takes(module, x)


def test_convbn3d_keeps_its_names_and_state():
    """``ConvBN3d`` keeps its ``nn.Conv3d`` and BatchNorm, their
    parameter names and its ``state_dict`` (checkpoints and MMAction2's
    names depend on them), and its output."""
    torch.manual_seed(0)
    block = ConvBN3d(8, 16, (1, 3, 3))
    assert isinstance(block.conv, nn.Conv3d)
    assert [n for n, _ in block.named_parameters()] == [
        'conv.weight', 'bn.weight', 'bn.bias']
    assert list(block.state_dict()) == [
        'conv.weight', 'bn.weight', 'bn.bias', 'bn.running_mean',
        'bn.running_var', 'bn.num_batches_tracked']
    other = ConvBN3d(8, 16, (1, 3, 3))
    other.load_state_dict(block.state_dict())
    x = torch.randn(2, 8, 3, 6, 7)
    assert torch.equal(block(x), F.relu(block.bn(block.conv(x))))


@pytest.mark.parametrize('case', CASES + CELL_SHAPES)
def test_plan_within_the_kernels_limits(case):
    """The plan's contract with the kernel: slabs, row tiles and segments
    cover the output; the staged window holds every column the taps reach,
    its rows and frames start on 16 bytes and the first channel's quads
    line up with the input row's; two stages and the groups' sums fit the
    block's shared memory; the threads fill most of a block and a slab
    holds a whole number of rounds of the groups' units."""
    x_shape, w_shape, stride, padding = case
    p = plan(x_shape, w_shape, stride, padding)
    assert p is not None
    z, t = p.sizes, p.tiling
    assert (z.N, z.Cin, z.T, z.H, z.W) == x_shape
    assert (z.Cout, z.Cin, z.KT, z.KH, p.kw) == w_shape
    assert (z.st, z.sh, p.sw) == stride and (z.pt, z.ph, z.pw) == padding
    assert t.nseg * t.seg >= z.Wo
    assert t.n_ht * t.TH >= z.Ho > (t.n_ht - 1) * t.TH
    assert t.slabs == z.N * z.To * t.n_ht
    assert t.entries == z.Cin * z.KT * z.KH * (z.Cout // CO_TILE)
    assert t.ent_cta * -(-t.entries // t.ent_cta) >= t.entries
    assert t.win_w == (z.Wo - 1) * p.sw + p.kw
    assert t.rs % 4 == 0 and t.rs >= t.lead + t.win_w * z.Cin
    assert (t.lead + z.pw * z.Cin) % 4 == 0
    assert t.fs % 4 == 0 and t.fs >= ((t.TH - 1) * z.sh + z.KH) * t.rs
    assert t.x_floats == z.KT * t.fs
    assert t.y_floats == t.TH * z.Wo * z.Cout
    assert 2 * 4 * (t.x_floats + t.y_floats) <= p.smem_bytes <= SMEM_BLOCK
    assert p.threads * p.kw * CO_TILE * 4 <= p.smem_bytes
    assert p.threads == t.ent_cta * t.groups
    assert MAX_THREADS // 2 < p.threads <= MAX_THREADS
    assert (t.TH * t.nseg) % t.groups == 0


@pytest.mark.parametrize('case', CASES)
def test_plan_covers_each_position_once(case):
    """Walked as the kernel walks it (slab s: n, t, a row tile; group g:
    units g, g + groups, ... of (row, segment); a segment: its positions
    below Wo), the plan takes every output position exactly once."""
    p = plan(*case)
    z, t = p.sizes, p.tiling
    seen = []
    for s in range(t.slabs):
        n, rest = divmod(s, z.To * t.n_ht)
        to, hot = divmod(rest, t.n_ht)
        rows = min(t.TH, z.Ho - hot * t.TH)
        for g in range(t.groups):
            for u in range(g, rows * t.nseg, t.groups):
                r, sg = divmod(u, t.nseg)
                wa = sg * t.seg
                seen += [(n, to, hot * t.TH + r, w)
                         for w in range(wa, min(wa + t.seg, z.Wo))]
    assert len(seen) == len(set(seen)) == z.N * z.To * z.Ho * z.Wo


def test_plan_refuses_what_the_kernel_does_not_take():
    assert plan((1, 8, 2, 5, 5), (8, 8, 1, 5, 5), (1, 1, 1),
                (0, 2, 2)) is None                       # KW 5
    assert plan((1, 8, 2, 5, 5), (12, 8, 1, 1, 1), (1, 1, 1),
                (0, 0, 0)) is None                       # Cout 12
    # a window row too wide for two stages of shared memory
    assert plan((1, 3, 7, 7, 8000), (8, 3, 5, 7, 7), (1, 2, 2),
                (2, 3, 3)) is None


def split_geometry(geo):
    """The C entry's 47 int64 (its ``Geometry``) by name."""
    assert len(geo) == 47
    return dict(sizes=Sizes(*geo[:16]), x_strides=geo[16:21],
                y_strides=geo[21:26], vec=geo[26:28],
                tiling=Tiling(*geo[28:42]), w_strides=geo[42:])


class Recorded:
    """A library whose entry computes dW from the geometry it is given:
    X and dY read through the geometry's sizes and strides, dW written
    through its dW strides (the kernel's contract, not its tiling)."""

    def __init__(self):
        self.calls = []
        # plain functions: the wrapper sets their ctypes argtypes
        self.vfs_narrow_wgrad3d = lambda *args: self.run(*args)
        self.vfs_narrow_wgrad3d_blocks_per_sm = lambda *args: 2

    def run(self, x_ptr, dy_ptr, part_ptr, dw_ptr, geo, n_geo, kw, sw,
            grid_x, smem, stream):
        g = split_geometry([int(v) for v in geo[:n_geo]])
        self.calls.append(dict(geo=g, kw=kw, sw=sw, grid_x=grid_x,
                               smem=smem, part=part_ptr))
        (n, t, h, w, cin, to, ho, wo, cout, kt, kh, st, sh, pt, ph,
         pw) = g['sizes']
        xs, ys, ws = g['x_strides'], g['y_strides'], g['w_strides']

        def view(ptr, shape, strides):
            span = 1 + sum((d - 1) * s for d, s in zip(shape, strides))
            flat = np.ctypeslib.as_array(
                (ctypes.c_float * span).from_address(ptr))
            return torch.as_strided(torch.from_numpy(flat), shape, strides)

        x = view(x_ptr, (n, cin, t, h, w), xs)
        dy = view(dy_ptr, (n, cout, to, ho, wo), ys)
        dw = view(dw_ptr, (cout, cin, kt, kh, kw), ws)
        dw.copy_(conv3d_weight_reference(
            x.double(), dy.double(), dw.double(), (st, sh, sw),
            (pt, ph, pw)))
        return 0


@pytest.fixture
def lib(monkeypatch):
    made = Recorded()
    monkeypatch.setattr(_build, 'load', lambda name: made)
    monkeypatch.setattr(conv3d_wgrad, 'check_tensors', lambda *a: None)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda index: types.SimpleNamespace(
                            multi_processor_count=3))
    monkeypatch.setattr(conv3d_wgrad.conv3d_weight_cuda, 'launches',
                        conv3d_wgrad.conv3d_weight_cuda.launches)
    conv3d_wgrad._grid_x.cache_clear()
    yield made
    conv3d_wgrad._grid_x.cache_clear()


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('case', CASES[:5])
def test_wrapper_passes_the_geometry(lib, case, layout):
    """The wrapper hands the C entry the plan, the strides of X, dY and
    dW (the weight's format), the family, a grid of at most the card's
    resident blocks and one slab a block, and a workspace of grid x |dW|
    floats; read back through that geometry, the inputs give the plain
    version's dW. One launch counts on the wrapper and, inside a
    recording, on the program counter."""
    x, grad_out, weight = (t.float() for t in inputs(case, layout))
    fn = conv3d_wgrad.conv3d_weight_cuda
    before = fn.launches
    with trace.recording() as rec:
        got = fn(x, grad_out, weight, case[2], case[3])
    [call] = lib.calls
    p = plan(*case)
    geo = call['geo']
    assert geo['sizes'] == p.sizes and geo['tiling'] == p.tiling
    assert (geo['x_strides'], geo['y_strides'], geo['w_strides']) == (
        list(x.stride()), list(grad_out.stride()), list(weight.stride()))
    def whole_quads(t):  # channels innermost, rows on 16 bytes
        s = t.stride()
        return (s[1] == 1 and s[4] == t.shape[1]
                and all(v % 4 == 0 for v in (s[0], s[2], s[3])))
    assert geo['vec'] == [whole_quads(x), whole_quads(grad_out)]
    assert geo['vec'][1] == (layout == 'ndhwc')
    assert (call['kw'], call['sw'], call['smem']) == (p.kw, p.sw,
                                                      p.smem_bytes)
    assert call['grid_x'] == min(p.tiling.slabs, 2 * 3)
    assert got.stride() == weight.stride()
    exact = torch.nn.grad.conv3d_weight(x.double(), weight.shape,
                                        grad_out.double(), case[2], case[3])
    assert (got.double() - exact).abs().max() <= 1e-5 * exact.abs().max()
    assert fn.launches == before + 1
    assert rec.counts == {conv3d_wgrad.TRACE_COUNT: 1}


def test_wrapper_counts_nothing_outside_a_recording(lib):
    case = CASES[1]
    x, grad_out, weight = (t.float() for t in inputs(case, 'ndhwc'))
    conv3d_wgrad.conv3d_weight_cuda(x, grad_out, weight, case[2], case[3])
    assert len(lib.calls) == 1 and not trace.active()
