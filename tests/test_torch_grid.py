"""Port vs JAX: ray-AABB intersection, the marching orbit, and the packed
sample set of the march (kernel G2's twin) against traverse_grids_padded +
compact_samples."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu import grid as jgrid
from nerfacc_tpu.utils.rendering import compact_samples as jax_compact_samples
from nerfacc_tpu_torch import grid as tgrid
from nerfacc_tpu_torch.utils.rendering import compact_samples
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

STEP = 5e-3
# A candidate whose midpoint lands within rounding of a voxel face or segment
# end may flip between the packages where they round one operation
# differently (pow under cone stepping, or a multiply-add that one compiler
# contracts into an FMA); at most this share of rays may differ.
FLIP_ALLOWANCE = 1e-3


def _rays(seed, n):
    """Rays from a radius-4 ring towards the box, some missing it."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1.5, 1.5, n)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), z], -1)
    target = rng.uniform(-2.0, 2.0, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _grid(seed, m, res=32):
    rng = np.random.default_rng(seed)
    binaries = rng.uniform(size=(m, res, res, res)) < 0.3
    roi = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)
    aabbs = np.stack([np.asarray(jgrid._enlarge_aabb(jnp.asarray(roi), 2**i)) for i in range(m)])
    return binaries, aabbs.astype(np.float32)


def test_ray_aabb_intersect_matches_jax_exactly():
    o, d = _rays(0, 64)
    # axis-parallel rays: 1/d is inf on two axes
    o[:3] = [[4.0, 0.1, 0.2], [0.3, -4.0, -0.1], [0.2, 0.2, 4.0]]
    d[:3] = [[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]]
    _, aabbs = _grid(0, 2)
    ref = jgrid.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabbs))
    out = tgrid.ray_aabb_intersect(torch.tensor(o), torch.tensor(d), torch.tensor(aabbs))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out[2][:3].all()


@pytest.mark.parametrize("cone_angle", [0.0, 0.004])
def test_orbit_matches_jax(cone_angle):
    near = np.array([0.0, 0.5, 2.0, 3.7], np.float32)
    k = np.arange(1500, dtype=np.float32)[None, :]
    ref = jgrid._orbit_t(jnp.asarray(near), jnp.asarray(k), STEP, cone_angle)
    out = tgrid._orbit_t(torch.tensor(near), torch.tensor(k), STEP, cone_angle)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "m,cone_angle,masked", [(1, 0.0, False), (2, 0.0, True), (2, 0.004, False)]
)
def test_march_matches_padded_traversal_and_compaction(m, cone_angle, masked):
    n_rays = 512
    o, d = _rays(1 + m, n_rays)
    binaries, aabbs = _grid(m, m)
    mask = np.random.default_rng(7).uniform(size=n_rays) < 0.8 if masked else None
    near = np.zeros(n_rays, np.float32)
    far = np.full(n_rays, 1e10, np.float32)

    out = tgrid.march(
        torch.tensor(o), torch.tensor(d), torch.tensor(binaries),
        torch.tensor(aabbs), torch.tensor(near), torch.tensor(far),
        step_size=STEP, cone_angle=cone_angle,
        rays_mask=None if mask is None else torch.tensor(mask),
    )
    packed = compact_samples(out)
    total = packed.num_valid
    # the JAX lattice must cover the whole orbit (the level-1 box reaches
    # t ~ 9.2 from radius 4); the budget the whole sample set
    max_samples = 2000 if cone_angle == 0.0 else 1000
    res = jgrid.traverse_grids_padded(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(binaries), jnp.asarray(aabbs),
        jnp.asarray(near), jnp.asarray(far), step_size=STEP,
        cone_angle=cone_angle, max_samples=max_samples,
        rays_mask=None if mask is None else jnp.asarray(mask),
    )
    assert np.asarray(res.terminated).all()
    ref = jax_compact_samples(res, total + 64)
    assert int(ref.overflow) == 0
    ref_counts = np.asarray(res.valid).sum(-1)
    counts = out.counts.numpy()
    differ = counts != ref_counts
    assert differ.mean() <= FLIP_ALLOWANCE, f"{differ.sum()} of {n_rays} rays differ"
    assert np.abs(counts - ref_counts).max(initial=0) <= 1
    assert packed.overflow == 0
    assert total > 1000

    # per ray, equal sample sets and bounds on every ray that did not flip
    ref_ids = np.asarray(ref.ray_indices)[: int(ref.num_valid)]
    ids = packed.ray_indices.numpy()
    keep, keep_ref = ~differ[ids], ~differ[ref_ids]
    np.testing.assert_array_equal(ids[keep], ref_ids[keep_ref])
    for name in ("t_starts", "t_ends"):
        a = getattr(packed, name).numpy()[keep]
        b = np.asarray(getattr(ref, name))[: int(ref.num_valid)][keep_ref]
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    # segment bounds: the contract of the JAX buffer (ends < starts if empty)
    ok = ~differ
    np.testing.assert_array_equal(
        (packed.seg_ends - packed.seg_starts + 1).numpy(), counts
    )
    np.testing.assert_array_equal(
        (np.asarray(ref.seg_ends) - np.asarray(ref.seg_starts) + 1)[ok], counts[ok]
    )
    np.testing.assert_allclose(
        out.termination_planes.numpy(), np.asarray(res.termination_planes),
        rtol=1e-6, atol=1e-6,
    )
    if mask is not None:
        assert (counts[~mask] == 0).all()


@pytest.mark.parametrize(
    "cone_angle,near_inside,masked",
    [(0.0, False, False), (0.004, False, True), (0.0, True, True), (0.004, True, False)],
)
def test_march_start_skips_only_the_empty_prefix(cone_angle, near_inside, masked):
    """Kernel G2's first candidate (``march_start``) against the padded
    traversal of JAX and of the twin: on an all-occupied grid the emitted
    candidates are exactly those with their midpoint in a valid segment, and
    none lies before it; on a real grid it is at or before the first emitted
    candidate.  Near 0 it skips the walk up to the box (to within two
    candidates of the first one inside, without a cone); a near plane inside
    the box starts at 0.  Some rays miss the box, some are masked."""
    n_rays = 256
    o, d = _rays(11, n_rays)
    d[:16] = -d[:16]  # pointing away: these miss both boxes
    binaries, aabbs = _grid(2, 2)
    rng = np.random.default_rng(12)
    # the level-1 box (+-3) starts at t ~ 1 from the radius-4 ring
    near = (rng.uniform(0.5, 5.0, n_rays) if near_inside else np.zeros(n_rays)).astype(np.float32)
    far = np.full(n_rays, 1e10, np.float32)
    mask = rng.uniform(size=n_rays) < 0.8 if masked else None
    k_start = tgrid.march_start(
        *map(torch.tensor, (o, d, aabbs, near, far)), STEP, cone_angle
    ).numpy()
    max_samples = 2000 if cone_angle == 0.0 else 1000

    def first_valid(valid):
        valid = np.asarray(valid)
        return np.where(valid.any(-1), valid.argmax(-1), valid.shape[1]), valid.any(-1)

    full = np.ones_like(binaries)
    for grid_ in (full, binaries):
        res = jgrid.traverse_grids_padded(
            *map(jnp.asarray, (o, d, grid_, aabbs, near, far)), step_size=STEP,
            cone_angle=cone_angle, max_samples=max_samples,
            rays_mask=None if mask is None else jnp.asarray(mask),
        )
        assert np.asarray(res.terminated).all()
        first, have = first_valid(res.valid)
        assert (k_start <= first).all()
        twin = tgrid.traverse_grids_padded(
            *map(torch.tensor, (o, d, grid_, aabbs, near, far)), step_size=STEP,
            cone_angle=cone_angle, rays_mask=None if mask is None else torch.tensor(mask),
        )
        twin_first, twin_have = first_valid(twin.valid.numpy())
        np.testing.assert_array_equal(twin_have, have)
        assert (k_start <= twin_first).all()
        if grid_ is full:
            in_segment, with_segment = first, have
    assert with_segment.sum() > n_rays // 2 and (~with_segment).any()
    gap = in_segment[with_segment] - k_start[with_segment]
    if near_inside:
        assert (k_start[with_segment] == 0).any() and (k_start > 0).any()
    else:
        # some origins on the ring lie inside the level-1 box (k_start 0)
        assert np.median(k_start[with_segment]) > 100
    if cone_angle == 0.0:
        assert (gap <= 2).mean() > 0.95


@pytest.mark.parametrize(
    "cone_angle,window,bitwise_t",
    [(0.0, 128, True), (0.0, 64, True), (0.004, 64, True), (0.004, 128, False)],
)
def test_windowed_march_matches_jax_round_by_round(cone_angle, window, bitwise_t):
    """``max_samples``: the plain march over one window of orbit candidates
    against JAX's ``traverse_grids_padded(max_samples=K)``, round after round
    from the previous round's termination planes, with a ray mask, as the
    eval renderer resumes its rays.  Candidates, valid flags, termination
    planes and ``terminated`` bitwise, every round: the first rounds emit
    nothing on most rays (the window counts from the near plane, and the
    first segment lies past it), rays pointing away have no segment.

    Under cone stepping the orbit's geometric part is ``t * pow(1 +
    cone, j)``, whose f32 ``pow`` XLA and PyTorch's CPU kernels round
    differently for some ``j`` (for 1.004 first at j = 78;
    ``test_orbit_matches_jax`` holds the orbit to 1e-6 for that reason).  A
    window of 64 restarts every round's orbit below that exponent, so it is
    held bitwise; a window of 128 reaches past it, and its bounds are held
    to 1e-6 while every flag stays bitwise."""
    n_rays = 256
    o, d = _rays(3, n_rays)
    d[:8] = -d[:8]  # pointing away: no segment
    binaries, aabbs = _grid(2, 1)  # the +-1.5 box: t ~ 2.5 to 5.5 from the ring
    mask = np.random.default_rng(5).uniform(size=n_rays) < 0.8
    near = np.zeros(n_rays, np.float32)
    far = np.full(n_rays, 1e10, np.float32)
    silent_rounds = emitted = 0
    for _ in range(1400 // window):
        args = (o, d, binaries, aabbs, near, far)
        ref = jgrid.traverse_grids_padded(
            *map(jnp.asarray, args), step_size=STEP, cone_angle=cone_angle,
            max_samples=window, rays_mask=jnp.asarray(mask),
        )
        out = tgrid.march_plain(
            *map(torch.tensor, args), step_size=STEP, cone_angle=cone_angle,
            rays_mask=torch.tensor(mask), max_samples=window,
        )
        valid = np.asarray(ref.valid)
        ray, k = np.nonzero(valid)
        np.testing.assert_array_equal(out.counts.numpy(), valid.sum(-1))
        np.testing.assert_array_equal(out.ray_indices.numpy(), ray)
        np.testing.assert_array_equal(out.terminated.numpy(), np.asarray(ref.terminated))
        for got, want in (
            (out.t_starts, np.asarray(ref.t_starts)[ray, k]),
            (out.t_ends, np.asarray(ref.t_ends)[ray, k]),
            (out.termination_planes, np.asarray(ref.termination_planes)),
        ):
            if bitwise_t:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        # masked rays emit nothing and keep their near planes
        assert (out.counts.numpy()[~mask] == 0).all()
        np.testing.assert_array_equal(out.termination_planes.numpy()[~mask], near[~mask])
        emitted += len(ray)
        silent_rounds += emitted == 0
        near = np.asarray(ref.termination_planes)
    terminated = np.asarray(ref.terminated)
    assert terminated[:8].all()  # no segment
    assert silent_rounds >= 2 and emitted > 1000
    # every ray the mask kept has left the box; the masked ones kept their
    # near planes, and those with a segment have not terminated
    assert terminated[mask].all() and not terminated[~mask].all()


def test_windowed_march_past_the_first_segment_emits_nothing():
    """A ray whose first segment begins past the window emits nothing, has
    not terminated, and resumes from ``t_edges[K]``; without a window the
    same rays terminate and keep the whole-orbit contract."""
    o, d = _rays(4, 64)
    binaries, aabbs = _grid(1, 1)  # the +-1.5 box: t ~ 2.5 on the ring
    near = np.zeros(64, np.float32)
    far = np.full(64, 1e10, np.float32)
    args = [torch.tensor(a) for a in (o, d, binaries, aabbs, near, far)]
    out = tgrid.march_plain(*args, step_size=STEP, max_samples=100)
    have = tgrid.traverse_grids_padded(*args, step_size=STEP).valid.any(-1)
    assert have.sum() > 32
    assert (out.counts == 0).all() and not out.terminated[have].any()
    np.testing.assert_array_equal(
        out.termination_planes[have].numpy(),
        tgrid._orbit_t(args[4], torch.tensor([[100.0]]), STEP, 0.0)[have, 0].numpy(),
    )
    full = tgrid.march_plain(*args, step_size=STEP)
    assert full.terminated.all() and int(full.counts.sum()) > 0
