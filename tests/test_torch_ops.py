"""vfs_tpu_torch host and decode ops against the JAX package: l2_normalize,
spatial_neighbor, resize_bilinear (upsample and the antialiased >2x
downsample), resize_nearest, pil_nearest_resize, normalize_logit and
make_propagation_config. Same numpy inputs through both; tolerances are
stated per op (fp32; the two sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.models.common.utils import normalize_logit as jax_normalize
from vfs_tpu.models.trackers.vanilla_tracker import \
    make_propagation_config as jax_make_cfg
from vfs_tpu.ops import affinity as jax_aff
from vfs_tpu.ops import resize as jax_resize
from vfs_tpu_torch.models.common.utils import normalize_logit
from vfs_tpu_torch.models.trackers.vanilla_tracker import \
    make_propagation_config
from vfs_tpu_torch.ops import affinity, resize

torch.set_num_threads(1)


def test_l2_normalize():
    x = np.random.RandomState(0).randn(3, 5, 7).astype(np.float32)
    x[0, 0] = 0.0  # the eps floor
    out = affinity.l2_normalize(torch.from_numpy(x), dim=-1).numpy()
    ref = np.asarray(jax_aff.l2_normalize(jnp.asarray(x), axis=-1))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('h,w,nr,mode,transpose', [
    (6, 7, 6, 'circle', False), (9, 5, 24, 'circle', False),
    (6, 7, 5, 'square', False), (5, 6, (3, 5), 'square', True)])
def test_spatial_neighbor(h, w, nr, mode, transpose):
    out = affinity.spatial_neighbor(h, w, nr, mode=mode, transpose=transpose)
    ref = jax_aff.spatial_neighbor(h, w, nr, mode=mode, transpose=transpose)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize('src,dst', [
    ((8, 13), (64, 104)),    # the decode upsample (8x)
    ((7, 9), (12, 15)),      # mild upsample
    ((12, 16), (7, 9)),      # <= 2x downsample: 2-tap
    ((64, 96), (8, 12)),     # > 2x downsample: antialiased (soft labels)
])
def test_resize_bilinear(src, dst):
    x = np.random.RandomState(1).rand(2, *src, 3).astype(np.float32)
    out = resize.resize_bilinear(torch.from_numpy(x), dst).numpy()
    ref = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), dst))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_resize_bilinear_upsample_is_interpolate():
    x = torch.rand(1, 6, 11, 2, generator=torch.Generator().manual_seed(2))
    out = resize.resize_bilinear(x, (48, 88))
    ref = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(48, 88), mode='bilinear',
        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('src,dst', [((8, 13), (20, 31)), ((20, 31), (8, 13))])
def test_resize_nearest(src, dst):
    x = np.random.RandomState(3).rand(1, *src, 2).astype(np.float32)
    out = resize.resize_nearest(torch.from_numpy(x), dst).numpy()
    ref = np.asarray(jax_resize.resize_nearest(jnp.asarray(x), dst))
    np.testing.assert_array_equal(out, ref)


def test_pil_nearest_resize():
    lab = np.random.RandomState(4).randint(0, 5, (61, 97)).astype(np.uint8)
    np.testing.assert_array_equal(resize.pil_nearest_resize(lab, (8, 13)),
                                  jax_resize.pil_nearest_resize(lab, (8, 13)))


def test_normalize_logit():
    x = np.random.RandomState(5).randn(3, 9, 11, 4).astype(np.float32)
    x[..., 1] = -np.abs(x[..., 1])  # a channel whose max is <= 0 stays
    out = normalize_logit(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out[..., 1], x[..., 1])


@pytest.mark.parametrize('test_cfg', [
    dict(precede_frames=20, topk=10, temperature=0.07, neighbor_range=24),
    dict(neighbor_range=36, backend='tiled', pallas_precision='bfloat16',
         video_qpair=2),
    dict(neighbor_range=24, with_first_neighbor=False),
])
def test_make_propagation_config_matches_jax(test_cfg):
    """Both packages pick the same fields, but for the two that route
    alike here: ``backend`` defaults to 'pallas_video' (the JAX package
    picks 'tiled' on the CPU; both run the same engine) and ``pallas_tile``
    (a TPU layout key) to the config's default. The dense mask (the
    non-local configs) is the same."""
    cfg, mask = make_propagation_config(test_cfg, 6, 7)
    ref_cfg, ref_mask = jax_make_cfg(test_cfg, 6, 7)
    assert cfg.backend == test_cfg.get('backend', 'pallas_video')
    assert cfg.pallas_tile == (8, 8)
    routing = dict(backend=ref_cfg.backend, pallas_tile=ref_cfg.pallas_tile)
    assert tuple(cfg._replace(**routing)) == tuple(ref_cfg)
    assert (mask is None) == (ref_mask is None)
    if mask is not None:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
