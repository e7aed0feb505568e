"""The port's image, detection and descriptor ops against the JAX package's.

Inputs: frames of the JAX package's synthetic renderer on the shared test
rig (two 200x150 cameras, 300 blobs), quantized to uint8 as the engine
uploads them, then converted to float32 as both packages' ``preprocess``
does. Everything here runs in float32 in both packages.

Tolerances:
- ``preprocess`` (NONE, HISTOGRAM, CLAHE), median: within 2e-6 absolute
  (float32 rounding of the CDF sums and blends; NONE and median exact);
  resize within 1e-5 (the JAX package computes its sample coordinates in
  the default float type, float64 here).
- ``detect`` at octaves 0 and 2: identical ``uv``, ``valid`` and ``octave``;
  scores within 1e-5 relative.
- ``describe``: ``PATTERN`` bit-identical; descriptors bit-identical on at
  least 99% of valid keypoints and no descriptor more than 2 bits off (a
  bit whose two bilinear samples tie to float32 rounding may flip between
  the JAX package's selection matmul and the port's direct gathers).
- ``gravity_angles`` to 1e-6.
- matching the frames' own descriptors (the fused matcher's plain version
  against the JAX package's ``match_descriptors``): integer-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svin_tpu import sim as jsim
from svin_tpu.ops import descriptor as jdesc
from svin_tpu.ops import detection as jdet
from svin_tpu.ops import hamming as jham
from svin_tpu.ops import image as jimg
from svin_tpu.pipeline.dataset import SyntheticRenderer
from svin_tpu_torch.ops import descriptor as tdesc
from svin_tpu_torch.ops import detection as tdet
from svin_tpu_torch.ops import image as timg
from svin_tpu_torch.ops.hamming import hamming_matrix_plain, match_descriptors_plain
from svin_tpu_torch.pipeline.programs import flow_mask
from vio_fixtures import small_rig

torch.set_num_threads(1)

THRESH = 40.0 * jdet.BRISK_THRESHOLD_SCALE


@pytest.fixture(scope="module")
def frames():
    r = SyntheticRenderer(small_rig(), n_points=300, seed=3,
                          traj=jsim.default_trajectory(scale=0.4, ramp_tau=0.8),
                          spread=6.0, depth_offset=3.0)
    out = []
    for t in (0.12, 0.95, 1.7):
        for im in r.render_frame(t):
            out.append(np.clip(im * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8))
    return out


def _f32(u8):
    return torch.as_tensor(u8).to(torch.float32) / 255.0


@pytest.mark.parametrize("method", ["NONE", "HISTOGRAM", "CLAHE"])
def test_preprocess_matches_jax(frames, method):
    for u8 in frames[:2]:
        want = np.asarray(jimg.preprocess(jnp.asarray(u8), histogram_method=method,
                                          clahe_clip_limit=2.0, clahe_tiles=8))
        got = timg.preprocess(torch.as_tensor(u8), histogram_method=method,
                              clahe_clip_limit=2.0, clahe_tiles=8)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_preprocess_batched_equals_per_image(frames):
    batch = torch.as_tensor(np.stack(frames[:2]))
    got = timg.preprocess(batch, histogram_method="CLAHE", clahe_tiles=4)
    for i in range(2):
        one = timg.preprocess(batch[i], histogram_method="CLAHE", clahe_tiles=4)
        assert torch.equal(got[i], one)


def test_resize_and_median_match_jax(frames):
    x = frames[0]
    f = _f32(x)
    want = np.asarray(jimg.resize_bilinear(jnp.asarray(f.numpy()), 90, 123))
    np.testing.assert_allclose(timg.resize_bilinear(f, 90, 123).numpy(), want, rtol=0, atol=1e-5)
    want = np.asarray(jimg.median_blur3(jnp.asarray(f.numpy())))
    np.testing.assert_array_equal(timg.median_blur3(f).numpy(), want)
    want = np.asarray(jimg.preprocess(jnp.asarray(x), resize_factor=0.5, use_median=True))
    got = timg.preprocess(torch.as_tensor(x), resize_factor=0.5, use_median=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("octaves", [0, 2])
def test_detect_matches_jax(frames, octaves):
    for u8 in frames:
        f = _f32(u8)
        want = jdet.detect(jnp.asarray(f.numpy()), max_keypoints=150, threshold=THRESH,
                           octaves=octaves)
        got = tdet.detect(f, max_keypoints=150, threshold=THRESH, octaves=octaves)
        assert int(got.valid.sum()) > 20
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
        np.testing.assert_array_equal(got.octave.numpy(), np.asarray(want.octave))
        np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), rtol=1e-5, atol=0)


def test_detect_cell_cap_matches_jax(frames):
    f = _f32(frames[1])
    want = jdet.detect(jnp.asarray(f.numpy()), max_keypoints=100, threshold=THRESH, cell=40,
                       cell_cap=3)
    got = tdet.detect(f, max_keypoints=100, threshold=THRESH, cell=40, cell_cap=3)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
    q = tdet.quadrant_counts(got, 200, 150).numpy()
    np.testing.assert_array_equal(q, np.asarray(jdet.quadrant_counts(want, 200, 150)))


def test_detect_batched_equals_per_image(frames):
    batch = torch.stack([_f32(u) for u in frames[:2]])
    got = tdet.detect(batch, max_keypoints=150, threshold=THRESH, octaves=2)
    for i in range(2):
        one = tdet.detect(batch[i], max_keypoints=150, threshold=THRESH, octaves=2)
        for a, b in zip(got, one):
            assert torch.equal(a[i], b)


def test_top_k_stable_orders_ties_by_index():
    x = torch.tensor([1.0, 3.0, 3.0, -float("inf"), 3.0, 2.0, -float("inf")])
    vals, idx = tdet.top_k_stable(x, 6)
    assert idx.tolist() == [1, 2, 4, 5, 0, 3]


def test_pattern_bit_identical():
    assert tdesc.PATTERN.dtype == jdesc.PATTERN.dtype
    np.testing.assert_array_equal(tdesc.PATTERN, jdesc.PATTERN)


@pytest.mark.parametrize("octaves", [0, 2])
def test_describe_matches_jax(frames, octaves):
    n_valid = n_exact = 0
    worst = 0
    for u8, g in zip(frames, ([0.1, 0.9, 0.3], [0.6, -0.5, 0.2], [0.0, 0.05, 1.0]) * 2):
        f = _f32(u8)
        kp = tdet.detect(f, max_keypoints=150, threshold=THRESH, octaves=octaves)
        g = torch.tensor(g, dtype=torch.float32)
        ang = tdesc.gravity_angles(kp.uv, g)
        jang = jdesc.gravity_angles(jnp.asarray(kp.uv.numpy()), jnp.asarray(g.numpy()))
        np.testing.assert_allclose(ang.numpy(), np.asarray(jang), rtol=0, atol=1e-6)
        got = tdesc.describe(f, kp.uv, ang, kp.valid, octave=kp.octave, max_octave=octaves)
        want = np.asarray(jdesc.describe(
            jnp.asarray(f.numpy()), jnp.asarray(kp.uv.numpy()), jnp.asarray(ang.numpy()),
            jnp.asarray(kp.valid.numpy()), octave=jnp.asarray(kp.octave.numpy()),
            max_octave=octaves)).view(np.int32)
        v = kp.valid.numpy()
        bits = hamming_matrix_plain(got[:, None, :], torch.as_tensor(want.copy())[:, None, :])[:, 0, 0].numpy()
        assert not got.numpy()[~v].any()
        n_valid += int(v.sum())
        n_exact += int((bits[v] == 0).sum())
        worst = max(worst, int(bits.max()))
    assert n_exact >= 0.99 * n_valid, (n_exact, n_valid)
    assert worst <= 2, worst


def test_renderer_from_jax_scene_matches_jax():
    """The port's renderer given the JAX renderer's scene
    (``convert.renderer_from_scene``) draws the same images: float32 within
    1e-5, and the uint8 frames the engines consume identical on all but a
    few pixels at a rounding boundary."""
    from svin_tpu_torch import sim as tsim
    from svin_tpu_torch.convert import renderer_from_scene
    from torch_parity import port_rig

    jr = SyntheticRenderer(small_rig(), n_points=300, seed=3,
                           traj=jsim.default_trajectory(scale=0.4, ramp_tau=0.8),
                           spread=6.0, depth_offset=3.0)
    scene = dict(points_W=np.asarray(jr.points_W), brightness=np.asarray(jr.brightness),
                 icov_a=np.asarray(jr._icov_a), icov_b=np.asarray(jr._icov_b),
                 icov_c=np.asarray(jr._icov_c), blob_sigma=jr.blob_sigma)
    tr = renderer_from_scene(port_rig(), tsim.default_trajectory(scale=0.4, ramp_tau=0.8), scene)
    for t in (0.12, 1.7):
        np.testing.assert_allclose(tr.pose(t).r.numpy(), np.asarray(jr.pose(t).r), rtol=0, atol=1e-12)
        for got, want in zip(tr.render_frame(t), jr.render_frame(t)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            q = lambda a: np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)  # noqa: E731
            assert (q(got) != q(want)).mean() < 1e-3


def _dense_render(r, T_WS, cam_idx):
    """The splat of every blob over every pixel, with the exponential
    evaluated everywhere and masked after (the renderer's formula before it
    evaluated only where a blob splats)."""
    from svin_tpu_torch.cameras import PinholeCamera, project
    from svin_tpu_torch.kinematics import compose, inverse, transform_point

    cam, T_SC = r.rig.cameras[cam_idx], r.rig.T_SC[cam_idx]
    T_WC = compose(T_WS, T_SC)
    p_C = transform_point(inverse(T_WC), r.points_W)
    cam32 = PinholeCamera(*(x.to(torch.float32) if isinstance(x, torch.Tensor) else x for x in cam))
    uv, valid = project(cam32, p_C.to(torch.float32))
    yy = torch.arange(cam.height, dtype=torch.float32)[:, None, None]
    xx = torch.arange(cam.width, dtype=torch.float32)[None, :, None]
    du, dv = xx - uv[None, None, :, 0], yy - uv[None, None, :, 1]
    q = r._icov_a * du * du + 2.0 * r._icov_b * du * dv + r._icov_c * dv * dv
    keep = valid & (du * du + dv * dv < 60.0 * r.blob_sigma ** 2)
    contrib = torch.where(keep, r.brightness * torch.exp(-0.5 * q), torch.zeros(()))
    return torch.clamp(torch.sum(contrib, dim=-1), 0.0, 1.0)


@pytest.mark.parametrize("t", [0.12, 3.3, 17.9])
def test_renderer_equals_the_dense_splat(t):
    """The port's renderer evaluates each Gaussian only where it splats and
    still sums over every blob: its images equal the dense formula's bit
    for bit (both cameras, blobs entering and leaving the image)."""
    from svin_tpu_torch import sim as tsim
    from svin_tpu_torch.pipeline.dataset import SyntheticRenderer as PortRenderer
    from torch_parity import port_rig

    r = PortRenderer(port_rig(), n_points=600, seed=0,
                     traj=tsim.default_trajectory(scale=0.4, ramp_tau=0.8), spread=6.0,
                     depth_offset=3.0)
    T = r.pose(t)
    for ci in range(2):
        img = r.render(T, ci)
        assert torch.equal(img, _dense_render(r, T, ci)) and float(img.max()) > 0.3


@pytest.mark.parametrize("ratio", [0.0, 0.8])
@pytest.mark.parametrize("pair", ["stereo", "temporal"])
def test_match_frame_descriptors_matches_jax(frames, ratio, pair):
    """The stereo matcher's pairing (camera 0 against camera 1, no mask) and
    the temporal one (camera 0 against its next frame under the optical-flow
    gate) on the frames' own descriptors: ``match_descriptors_plain``
    against the JAX ``match_descriptors``, exact."""
    def kp_desc(u8):
        f = _f32(u8)
        kp = tdet.detect(f, max_keypoints=150, threshold=THRESH, octaves=2)
        ang = tdesc.gravity_angles(kp.uv, torch.tensor([0.1, 0.9, 0.3]))
        return kp, tdesc.describe(f, kp.uv, ang, kp.valid, octave=kp.octave, max_octave=2)

    (ka, da), (kb, db) = kp_desc(frames[0]), kp_desc(frames[1 if pair == "stereo" else 2])
    mask = None if pair == "stereo" else flow_mask(ka.uv, kb.uv, 250.0)
    got = match_descriptors_plain(da, db, ka.valid, kb.valid, mask, max_distance=60, ratio=ratio)
    want = jham.match_descriptors(
        jnp.asarray(da.numpy().view(np.uint32)), jnp.asarray(db.numpy().view(np.uint32)),
        jnp.asarray(ka.valid.numpy()), jnp.asarray(kb.valid.numpy()),
        None if mask is None else jnp.asarray(mask.numpy()), max_distance=60, ratio=ratio)
    assert int(got.valid.sum()) >= 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
