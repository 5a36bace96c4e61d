"""Procedural benchmark scenes: Gaussian density blobs rendered analytically
to ground-truth images, still or moving.

PyTorch counterpart of nerfacc_tpu/data/procedural.py: its eight scenes
(the translucent blobs, the opaque, textured, thin and mixed variants, the
unbounded scene and the two dynamic scenes), ``PROCEDURAL_SCENES`` with the
JAX package's eight names, and ``UNBOUNDED_SCENES``, the names the examples'
unbounded configurations take.  The scene constants come from the same
numpy draws as the JAX loaders' (``np.random.default_rng(1234)`` for the
blobs, 4321 for the motion and the opaque densities, 777 for the unbounded
scene's far blobs, 9999 for the textures, 8888 for the rods, 7777 for the
fog and 5555 for the local motion) and the camera rays from the same numpy
arithmetic, so both packages build the identical scene and rays; the ground
truth is integrated in PyTorch on the loader's device (no disk cache).
Ported: the test split and the train split's random ray batches, whose
pixels come from the same ``np.random.default_rng(seed)`` call sequence as
the JAX loader's, so both loaders yield identical batches, as rays or, for
BARF, as pixels (``pixel_batch``).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def _look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """OpenGL-style camera-to-world matrix (camera looks down -z)."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = s
    c2w[:3, 1] = u
    c2w[:3, 2] = -f
    c2w[:3, 3] = eye
    return c2w


class ProceduralSceneLoader:
    """Analytic-blob scene with the SubjectLoader interface.

    Args:
        split: "train" or "test" camera ring.
        num_blobs: Gaussian density blobs (``NUM_BLOBS`` by default).
        n_train / n_test: camera counts on a ring, looking at the origin.
        width / height: image resolution.
        num_rays: train-split ray batch; None (or the test split) makes
            every item a whole view.
        color_bkgd_aug: background of a train batch, "white", "black" or
            "random" (one colour per batch).
        seed: seeds the batches' pixel draws.
        aabb_half: the scene box's half side (``AABB_HALF``); the blob
            centres lie within 0.8 of it.
        gt_samples: uniform samples per ray of the analytic render
            (``GT_SAMPLES``).
        device: where the ground truth is rendered and items are returned
            (the card unless the caller asks for another).

    The JAX loader's arguments, in its order, and ``device``.
    """

    NEAR, FAR = 2.0, 6.0
    OPENGL_CAMERA = True
    NUM_BLOBS = 24
    AABB_HALF = 1.2  # blob centres lie within 0.8 of this
    GT_SAMPLES = 512  # uniform samples per ray of the analytic render

    def __init__(
        self,
        split: str = "train",
        num_blobs: int = NUM_BLOBS,
        n_train: int = 24,
        n_test: int = 4,
        width: int = 320,
        height: int = 320,
        num_rays: Optional[int] = None,
        color_bkgd_aug: str = "white",
        seed: int = 42,
        aabb_half: float = AABB_HALF,
        gt_samples: int = GT_SAMPLES,
        device: Union[str, torch.device] = "cuda",
    ):
        self.NUM_BLOBS, self.AABB_HALF = int(num_blobs), float(aabb_half)
        self.GT_SAMPLES = int(gt_samples)
        self.split = split
        self.WIDTH, self.HEIGHT = width, height
        self.num_rays = num_rays
        self.training = num_rays is not None and split == "train"
        self.color_bkgd_aug = color_bkgd_aug
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        half, n_blobs = self.AABB_HALF, self.NUM_BLOBS
        self.aabb = np.array([-half] * 3 + [half] * 3, dtype=np.float32)

        rng = np.random.default_rng(1234)  # scene is fixed across seeds
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        self.blob_centers = f32(rng.uniform(-0.8 * half, 0.8 * half, (n_blobs, 3)))
        self.blob_scales = f32(rng.uniform(0.05, 0.22, (n_blobs,)))
        self.blob_density = f32(self._blob_density(rng))
        self.blob_colors = f32(rng.uniform(0.1, 1.0, (n_blobs, 3)))

        n_views = n_train if split == "train" else n_test
        phase = 0.0 if split == "train" else 0.5 / max(n_test, 1)
        self.camtoworlds = self._poses(n_views, phase)

        self.focal = 0.5 * width / np.tan(0.5 * np.deg2rad(50.0))
        self.K = np.array(
            [[self.focal, 0, width / 2.0], [0, self.focal, height / 2.0], [0, 0, 1]],
            dtype=np.float32,
        )
        self.images = self._render_gt_images()

    def _poses(self, n_views: int, phase: float) -> np.ndarray:
        """(n_views, 4, 4) cameras on a sphere of radius 4, at elevations
        between -50 and -10 degrees, looking at the origin."""
        poses = []
        for i in range(n_views):
            theta = 2 * np.pi * (i / n_views + phase)
            phi = np.deg2rad(-30.0 + 20.0 * np.sin(3 * theta))
            eye = 4.0 * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
            )
            poses.append(
                _look_at(eye.astype(np.float32), np.zeros(3), np.array([0, 0, 1.0]))
            )
        return np.stack(poses).astype(np.float32)

    # -- analytic field -----------------------------------------------------
    def _blob_density(self, rng: np.random.Generator) -> np.ndarray:
        """The blobs' peak densities, drawn from the scene's ``rng``: dense
        blobs, so that rays saturate within a few samples of the surface."""
        return rng.uniform(80.0, 300.0, (self.NUM_BLOBS,))

    def _centers(self, view: int) -> torch.Tensor:
        """Blob centres (B, 3) as view ``view`` sees them."""
        return self.blob_centers

    def query_density(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        """sigma(x): sum of Gaussian blobs. (N, 3) -> (N, 1)."""
        return self._blob_weights(x, centers).sum(dim=-1, keepdim=True)

    def query_rgb(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        w = self._blob_weights(x, centers)
        w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-8)
        return w @ self.blob_colors

    def _blob_weights(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        d2 = ((x[:, None, :] - centers[None]) ** 2).sum(dim=-1)  # (N, B)
        return self.blob_density * torch.exp(-0.5 * d2 / self.blob_scales**2)

    # -- ground-truth rendering --------------------------------------------
    def _gt_edges(self) -> torch.Tensor:
        """The analytic render's sample edges along every ray."""
        return torch.linspace(self.NEAR, self.FAR, self.GT_SAMPLES + 1, device=self.device)

    def _render_rays_gt(self, rays_o: torch.Tensor, rays_d: torch.Tensor, centers):
        t = self._gt_edges()
        t0, t1 = t[:-1], t[1:]
        tm = 0.5 * (t0 + t1)
        pos = rays_o[:, None, :] + tm[None, :, None] * rays_d[:, None, :]
        flat = pos.reshape(-1, 3)
        sigma = self.query_density(flat, centers).reshape(pos.shape[:2])
        rgb = self.query_rgb(flat, centers).reshape(pos.shape[:2] + (3,))
        sdt = sigma * (t1 - t0)[None, :]
        alpha = 1.0 - torch.exp(-sdt)
        trans = torch.exp(-torch.cumsum(sdt, dim=-1) + sdt)
        weights = trans * alpha
        color = (weights[..., None] * rgb).sum(dim=1)
        opacity = weights.sum(dim=1, keepdim=True)
        return color, opacity

    @torch.no_grad()
    def _render_gt_images(self) -> torch.Tensor:
        """(n_views, H, W, 4) uint8 RGBA."""
        x, y = self._pixel_grid()
        imgs = []
        for i in range(len(self.camtoworlds)):
            o, d = self._rays_for_pixels(np.full_like(x, i), x, y)
            centers = self._centers(i)
            rgba = []
            chunk = 4096
            for s in range(0, len(x), chunk):
                c, a = self._render_rays_gt(o[s : s + chunk], d[s : s + chunk], centers)
                rgba.append(torch.cat([c, a], dim=-1))
            rgba = torch.cat(rgba).reshape(self.HEIGHT, self.WIDTH, 4)
            imgs.append((rgba * 255).clamp(0, 255).to(torch.uint8))
        return torch.stack(imgs)

    # -- SubjectLoader interface -------------------------------------------
    def __len__(self):
        return len(self.camtoworlds)

    def update_num_rays(self, num_rays: int) -> None:
        self.num_rays = num_rays

    def _pixel_grid(self):
        x, y = np.meshgrid(np.arange(self.WIDTH), np.arange(self.HEIGHT), indexing="xy")
        return x.reshape(-1), y.reshape(-1)

    def _rays_for_pixels(self, image_id, x, y):
        """Origins and unit directions, computed in numpy exactly as the JAX
        package does, returned as f32 tensors on the loader's device."""
        c2w = self.camtoworlds[image_id]
        camera_dirs = np.stack(
            [
                (x + 0.5 - self.K[0, 2]) / self.K[0, 0],
                (y + 0.5 - self.K[1, 2]) / self.K[1, 1] * -1.0,
                np.full_like(x, -1.0, dtype=np.float32),
            ],
            axis=-1,
        )
        directions = (camera_dirs[..., None, :] * c2w[..., :3, :3]).sum(-1)
        origins = np.broadcast_to(c2w[..., :3, -1], directions.shape)
        viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
        return (
            torch.tensor(origins.astype(np.float32), device=self.device),
            torch.tensor(viewdirs.astype(np.float32), device=self.device),
        )

    def _select_pixels(self, index: int):
        """(image ids, x, y, background) of one item, drawn from ``self.rng``
        in the JAX loader's order when training."""
        if self.training:
            n = self.num_rays
            image_id = self.rng.integers(0, len(self), size=(n,))
            x = self.rng.integers(0, self.WIDTH, size=(n,))
            y = self.rng.integers(0, self.HEIGHT, size=(n,))
            if self.color_bkgd_aug == "random":
                color_bkgd = self.rng.random(3, dtype=np.float32)
            elif self.color_bkgd_aug == "white":
                color_bkgd = np.ones(3, np.float32)
            else:
                color_bkgd = np.zeros(3, np.float32)
        else:
            x, y = self._pixel_grid()
            image_id = np.full_like(x, index)
            color_bkgd = np.ones(3, np.float32)
        return image_id, x, y, color_bkgd

    def __getitem__(self, index: int):
        """A train ray batch or one full view: rays and the ground truth
        alpha-blended over the item's background."""
        return self._item(*self._select_pixels(index))

    def pixel_batch(self, index: int):
        """A train batch as pixels, for a trainer that makes the rays from
        poses it refines (BARF): ``{img_ids, x, y}`` (int32), the pixels'
        ``rgb`` over the batch's ``color_bkgd``, on the loader's device,
        from the draws :meth:`__getitem__` makes."""
        image_id, x, y, color_bkgd = self._select_pixels(index)
        pick = tuple(torch.as_tensor(a, device=self.device) for a in (image_id, y, x))
        rgba = self.images[pick].to(torch.float32) / 255.0
        color_bkgd = torch.tensor(color_bkgd, device=self.device)
        as_int = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=self.device)
        return {
            "img_ids": as_int(image_id), "x": as_int(x), "y": as_int(y),
            "rgb": rgba[:, :3] * rgba[:, 3:] + color_bkgd * (1.0 - rgba[:, 3:]),
            "color_bkgd": color_bkgd,
        }

    def _item(self, image_id, x, y, color_bkgd):
        pick = tuple(torch.as_tensor(a, device=self.device) for a in (image_id, y, x))
        rgba = self.images[pick].to(torch.float32) / 255.0
        origins, viewdirs = self._rays_for_pixels(image_id, x, y)
        color_bkgd = torch.tensor(color_bkgd, device=self.device)
        pixels = rgba[:, :3] * rgba[:, 3:] + color_bkgd * (1.0 - rgba[:, 3:])
        return {
            "rgb": pixels,
            "rays_o": origins,
            "rays_d": viewdirs,
            "color_bkgd": color_bkgd,
        }


class ProceduralDynamicSceneLoader(ProceduralSceneLoader):
    """The blob scene in motion (the D-NeRF role): each blob oscillates
    along a fixed direction, ``c(t) = c + motion_amp sin(2 pi t + phase) dir``,
    and view ``i`` is captured at ``view_times[i] = linspace(0, 1, n)[i]``
    (one frame per time).  Every item carries the per-ray ``timestamps``
    (n_rays, 1); ``timestamps`` (n_views, 1) holds all frame times, for the
    trainer's occupancy refresh.  Takes the arguments of
    :class:`ProceduralSceneLoader`, and ``motion_amp``.
    ``query_density_t(x, t)`` / ``query_rgb_t(x, t)`` read the scene at
    time ``t``.
    """

    def __init__(
        self,
        split: str = "train",
        num_blobs: int = ProceduralSceneLoader.NUM_BLOBS,
        n_train: int = 24,
        n_test: int = 4,
        width: int = 320,
        height: int = 320,
        num_rays: Optional[int] = None,
        color_bkgd_aug: str = "white",
        seed: int = 42,
        aabb_half: float = ProceduralSceneLoader.AABB_HALF,
        gt_samples: int = ProceduralSceneLoader.GT_SAMPLES,
        motion_amp: float = 0.25,
        device: Union[str, torch.device] = "cuda",
    ):
        # the motion exists before the base constructor renders the ground
        # truth; its draws are the JAX loader's, normals then uniforms
        mrng = np.random.default_rng(4321)  # fixed across seeds, like the scene
        dirs = mrng.normal(size=(num_blobs, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        phase = mrng.uniform(0.0, 2 * np.pi, (num_blobs,))
        self.motion_dirs = torch.tensor(dirs, dtype=torch.float32, device=device)
        self.motion_phase = torch.tensor(phase, dtype=torch.float32, device=device)
        self.motion_amp = float(motion_amp)
        n = n_train if split == "train" else n_test
        self.view_times = np.linspace(0.0, 1.0, max(n, 2))[:n].astype(np.float32)
        super().__init__(split, num_blobs, n_train, n_test, width, height, num_rays,
                         color_bkgd_aug, seed, aabb_half, gt_samples, device)
        self.timestamps = torch.tensor(self.view_times[:, None], device=self.device)

    def _centers(self, view: int):
        return self._centers_at(torch.tensor(self.view_times[view], device=self.device))

    def _centers_at(self, t: torch.Tensor):
        """Blob centres (B, 3) at time ``t``."""
        osc = torch.sin(2 * np.pi * t + self.motion_phase)[:, None]
        return self.blob_centers + self.motion_amp * osc * self.motion_dirs

    def query_density_t(self, x: torch.Tensor, t) -> torch.Tensor:
        """sigma(x) at time ``t`` (a float or a 0-d tensor). (N, 3) -> (N, 1)."""
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        return self.query_density(x, self._centers_at(t))

    def query_rgb_t(self, x: torch.Tensor, t) -> torch.Tensor:
        """The blobs' colour mix at ``x`` at time ``t``. (N, 3) -> (N, 3)."""
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        return self.query_rgb(x, self._centers_at(t))

    def _item(self, image_id, x, y, color_bkgd):
        item = super()._item(image_id, x, y, color_bkgd)
        item["timestamps"] = torch.tensor(
            self.view_times[image_id][:, None], device=self.device
        )
        return item


class ProceduralOpaqueSceneLoader(ProceduralSceneLoader):
    """The hard-surface variant of the blob scene: solid balls of density
    ``D * sigmoid((R_i - r) / edge_width)`` in place of Gaussians, ``D``
    drawn from ``default_rng(4321)`` in [400, 800] and ``R_i`` the blob
    scales.  Inside a ball a 5e-3 step has alpha ~0.9, so rays saturate
    within a few samples of a surface: the regime where the eval renderer's
    early stopping pays (the translucent scene leaves ~180 samples a ray).
    Takes the arguments of :class:`ProceduralSceneLoader`, and
    ``edge_width``.
    """

    def __init__(
        self,
        split: str = "train",
        num_blobs: int = ProceduralSceneLoader.NUM_BLOBS,
        n_train: int = 24,
        n_test: int = 4,
        width: int = 320,
        height: int = 320,
        num_rays: Optional[int] = None,
        color_bkgd_aug: str = "white",
        seed: int = 42,
        aabb_half: float = ProceduralSceneLoader.AABB_HALF,
        gt_samples: int = ProceduralSceneLoader.GT_SAMPLES,
        edge_width: float = 0.01,
        device: Union[str, torch.device] = "cuda",
    ):
        self.edge_width = float(np.float32(edge_width))
        super().__init__(split, num_blobs, n_train, n_test, width, height, num_rays,
                         color_bkgd_aug, seed, aabb_half, gt_samples, device)

    def _blob_density(self, rng: np.random.Generator) -> np.ndarray:
        super()._blob_density(rng)  # the scene's later draws stay the same
        return np.random.default_rng(4321).uniform(400.0, 800.0, (self.NUM_BLOBS,))

    def _blob_weights(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        r = ((x[:, None, :] - centers[None]) ** 2).sum(dim=-1).sqrt()  # (N, B)
        return self.blob_density * torch.sigmoid(
            (self.blob_scales[None] - r) / self.edge_width
        )


class ProceduralTexturedSceneLoader(ProceduralOpaqueSceneLoader):
    """The opaque scene with high-frequency albedo: each colour channel of
    the balls is modulated by ``0.55 + 0.45 sum_k w_ck sin(x . f_ck +
    phi_ck)``, clipped to [0.1, 1], over ``num_gratings`` gratings of 8 to
    32 radians a unit, drawn from ``default_rng(9999)``.  Fine texture
    separates encoders by their high-frequency capacity.  Takes the
    arguments of :class:`ProceduralOpaqueSceneLoader`, and ``num_gratings``.
    """

    def __init__(self, *args, num_gratings: int = 6, **kwargs):
        rng = np.random.default_rng(9999)  # texture fixed across seeds
        k = num_gratings
        freq = rng.uniform(8.0, 32.0, (3, k, 1))
        dirs = rng.normal(size=(3, k, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        device = kwargs.get("device", "cuda")
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.tex_freqs = f32(freq * dirs)  # (3, k, 3)
        self.tex_phases = f32(rng.uniform(0.0, 2 * np.pi, (3, k)))
        self.tex_weights = f32(rng.dirichlet(np.ones(k), 3))  # (3, k), rows sum to 1
        super().__init__(*args, **kwargs)

    def _texture(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3) multiplicative albedo in [0.1, 1]."""
        ph = torch.einsum("nd,ckd->ckn", x, self.tex_freqs) + self.tex_phases[..., None]
        pat = torch.einsum("ck,ckn->cn", self.tex_weights, torch.sin(ph))  # (3, N)
        return (0.55 + 0.45 * pat).T.clamp(0.1, 1.0)

    def query_rgb(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        return super().query_rgb(x, centers) * self._texture(x)


class ProceduralThinSceneLoader(ProceduralSceneLoader):
    """Thin geometry: ``num_rods`` hard capsules of radius 0.02-0.04 (a
    128^3 grid over +-1.5 has 23 mm cells) and one thin spherical shell of
    radius 0.55, from ``default_rng(8888)``; the blobs take no part.  Takes
    the arguments of :class:`ProceduralSceneLoader`, and ``num_rods``.
    """

    SHELL_RADIUS, SHELL_WIDTH, EDGE_WIDTH = 0.55, 0.015, 0.008
    SHELL_RGB = (0.85, 0.8, 0.3)

    def __init__(self, *args, num_rods: int = 14, **kwargs):
        rng = np.random.default_rng(8888)  # scene fixed across seeds
        half = 0.9
        a = rng.uniform(-half, half, (num_rods, 3))
        d = rng.normal(size=(num_rods, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        length = rng.uniform(0.6, 1.6, (num_rods, 1))
        b = np.clip(a + length * d, -1.05, 1.05)
        device = kwargs.get("device", "cuda")
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        self.rod_a, self.rod_b = f32(a), f32(b)
        self.rod_radius = f32(rng.uniform(0.02, 0.04, (num_rods,)))
        self.rod_colors = f32(rng.uniform(0.15, 1.0, (num_rods, 3)))
        self.shell_rgb = f32(self.SHELL_RGB)
        super().__init__(*args, **kwargs)

    def _rod_weights(self, x: torch.Tensor) -> torch.Tensor:
        """(N, M) hard-edged capsule densities."""
        a, b = self.rod_a[None], self.rod_b[None]  # (1, M, 3)
        ab = b - a
        t = (((x[:, None, :] - a) * ab).sum(dim=-1) / (ab * ab).sum(dim=-1)).clamp(0.0, 1.0)
        closest = a + t[..., None] * ab
        r = torch.linalg.norm(x[:, None, :] - closest, dim=-1)
        return 600.0 * torch.sigmoid((self.rod_radius[None] - r) / self.EDGE_WIDTH)

    def _shell_weight(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.linalg.norm(x, dim=-1)
        return 400.0 * torch.exp(-0.5 * ((r - self.SHELL_RADIUS) / self.SHELL_WIDTH) ** 2)

    def query_density(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        return (self._rod_weights(x).sum(dim=-1) + self._shell_weight(x))[:, None]

    def query_rgb(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        w_rod = self._rod_weights(x)
        w_sh = self._shell_weight(x)[:, None]
        total = (w_rod.sum(dim=-1, keepdim=True) + w_sh).clamp_min(1e-8)
        return (w_rod @ self.rod_colors + w_sh * self.shell_rgb) / total


class ProceduralMixedSceneLoader(ProceduralOpaqueSceneLoader):
    """Mixed opacity: the opaque scene's solid balls inside ``num_fog``
    large translucent Gaussian fog blobs (peak density 2-7) from
    ``default_rng(7777)``: early termination pays on some rays while others
    cross fog the grid must keep occupied.  Takes the arguments of
    :class:`ProceduralOpaqueSceneLoader`, and ``num_fog``.
    """

    def __init__(self, *args, num_fog: int = 8, **kwargs):
        rng = np.random.default_rng(7777)  # scene fixed across seeds
        device = kwargs.get("device", "cuda")
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.fog_centers = f32(rng.uniform(-0.85, 0.85, (num_fog, 3)))
        self.fog_scales = f32(rng.uniform(0.25, 0.5, (num_fog,)))
        self.fog_density = f32(rng.uniform(2.0, 7.0, (num_fog,)))
        self.fog_colors = f32(rng.uniform(0.3, 1.0, (num_fog, 3)))
        super().__init__(*args, **kwargs)

    def _fog_weights(self, x: torch.Tensor) -> torch.Tensor:
        d2 = ((x[:, None, :] - self.fog_centers[None]) ** 2).sum(dim=-1)
        return self.fog_density * torch.exp(-0.5 * d2 / self.fog_scales**2)

    def query_density(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        solid = self._blob_weights(x, centers).sum(dim=-1)
        return (solid + self._fog_weights(x).sum(dim=-1))[:, None]

    def query_rgb(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        w_solid = self._blob_weights(x, centers)
        w_fog = self._fog_weights(x)
        total = (
            w_solid.sum(dim=-1, keepdim=True) + w_fog.sum(dim=-1, keepdim=True)
        ).clamp_min(1e-8)
        return (w_solid @ self.blob_colors + w_fog @ self.fog_colors) / total


class ProceduralUnboundedSceneLoader(ProceduralSceneLoader):
    """The unbounded (Mip-NeRF 360 role) scene: ``NUM_BLOBS`` object blobs
    within ``0.8 * AABB_HALF`` of the origin, a ground slab at
    ``GROUND_Z0`` fading out towards ``CONTENT_RADIUS``, and
    ``NUM_FAR_BLOBS`` large blobs resting on it in a ring 4 to
    ``CONTENT_RADIUS - 0.5`` from the axis, far outside the unit region.
    The cameras sit on a ring of radius 1.8, 0.6 + 0.15 sin(2 theta) above
    the ground plane's origin, looking at the origin, so the object fills
    the centre of every view and the ground and far blobs its background.

    The far blobs come from ``np.random.default_rng(777)`` in the JAX
    loader's order of draws (angle, radius, scale, height factor, density,
    colour); the object blobs from the base class's ``default_rng(1234)``.
    The ground truth integrates ``GT_SAMPLES`` uniform samples from NEAR to
    ``T_SPLIT`` and ``GT_FAR_SAMPLES`` uniform in disparity from there to
    FAR.  Takes the JAX loader's arguments, in its order (``num_blobs``,
    ``gt_samples``, ``gt_far_samples``, ``content_radius`` and
    ``num_far_blobs`` default to the class constants), and ``device``.
    """

    NEAR, FAR = 0.05, 20.0
    NUM_BLOBS = 16
    AABB_HALF = 0.7  # the object's blobs stay within the unit region
    NUM_FAR_BLOBS = 12
    CONTENT_RADIUS = 6.5  # everything the ground truth sees lies within it
    GROUND_Z0, GROUND_H, GROUND_DENSITY = -0.55, 0.12, 150.0
    T_SPLIT = 3.0  # where the ground truth's samples turn uniform in disparity
    GT_FAR_SAMPLES = 256

    def __init__(
        self,
        split: str = "train",
        num_blobs: int = NUM_BLOBS,
        n_train: int = 24,
        n_test: int = 4,
        width: int = 320,
        height: int = 320,
        num_rays: Optional[int] = None,
        color_bkgd_aug: str = "white",
        seed: int = 42,
        gt_samples: int = ProceduralSceneLoader.GT_SAMPLES,
        gt_far_samples: int = GT_FAR_SAMPLES,
        content_radius: float = CONTENT_RADIUS,
        num_far_blobs: int = NUM_FAR_BLOBS,
        device: Union[str, torch.device] = "cuda",
    ):
        self.GT_FAR_SAMPLES, self.CONTENT_RADIUS = int(gt_far_samples), float(content_radius)
        self.NUM_FAR_BLOBS = int(num_far_blobs)
        # the far content exists before the base constructor renders the
        # ground truth.  Centres 4 or more from the axis with scales of at
        # most 0.45 leave the camera ring (radius 1.8) in free space.
        rng = np.random.default_rng(777)  # fixed across seeds, like the scene
        n = self.NUM_FAR_BLOBS
        theta = rng.uniform(0.0, 2 * np.pi, n)
        radius = rng.uniform(4.0, self.CONTENT_RADIUS - 0.5, n)
        scale = rng.uniform(0.25, 0.45, n)
        centers = np.stack(
            [radius * np.cos(theta), radius * np.sin(theta),
             self.GROUND_Z0 + scale * rng.uniform(0.8, 1.6, n)],
            axis=-1,
        )
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.far_centers = f32(centers)
        self.far_scales = f32(scale)
        self.far_density = f32(rng.uniform(100.0, 250.0, n))
        self.far_colors = f32(rng.uniform(0.1, 1.0, (n, 3)))
        super().__init__(split, num_blobs, n_train, n_test, width, height, num_rays,
                         color_bkgd_aug, seed, self.AABB_HALF, gt_samples, device)

    def _poses(self, n_views: int, phase: float) -> np.ndarray:
        poses = []
        for i in range(n_views):
            th = 2 * np.pi * (i / n_views + phase)
            eye = np.array([1.8 * np.cos(th), 1.8 * np.sin(th), 0.6 + 0.15 * np.sin(2 * th)])
            poses.append(
                _look_at(eye.astype(np.float32), np.zeros(3), np.array([0, 0, 1.0]))
            )
        return np.stack(poses).astype(np.float32)

    # -- analytic field (object blobs + ground + far blobs) ------------------
    def _ground_sigma(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.linalg.norm(x[:, :2], dim=-1)
        fade = torch.sigmoid((self.CONTENT_RADIUS - 0.5 - r) / 0.4)
        slab = torch.exp(-0.5 * ((x[:, 2] - self.GROUND_Z0) / self.GROUND_H) ** 2)
        return self.GROUND_DENSITY * slab * fade

    def _ground_rgb(self, x: torch.Tensor) -> torch.Tensor:
        """A smooth, low-frequency albedo, which a field can fit."""
        u = 0.5 + 0.25 * torch.sin(1.3 * x[:, 0]) * torch.cos(0.9 * x[:, 1])
        v = 0.45 + 0.2 * torch.sin(0.6 * (x[:, 0] + x[:, 1]))
        return torch.stack([0.35 + 0.3 * u, 0.3 + 0.35 * v, 0.25 + 0.2 * u * v], -1)

    def _far_weights(self, x: torch.Tensor) -> torch.Tensor:
        d2 = ((x[:, None, :] - self.far_centers[None]) ** 2).sum(dim=-1)
        return self.far_density * torch.exp(-0.5 * d2 / self.far_scales**2)

    def query_density(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        inner = self._blob_weights(x, centers).sum(dim=-1)
        far = self._far_weights(x).sum(dim=-1)
        return (inner + far + self._ground_sigma(x))[:, None]

    def query_rgb(self, x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        w_in = self._blob_weights(x, centers)
        w_far = self._far_weights(x)
        w_g = self._ground_sigma(x)[:, None]
        total = (
            w_in.sum(dim=-1, keepdim=True) + w_far.sum(dim=-1, keepdim=True) + w_g
        ).clamp_min(1e-8)
        rgb = w_in @ self.blob_colors + w_far @ self.far_colors + w_g * self._ground_rgb(x)
        return rgb / total

    def _gt_edges(self) -> torch.Tensor:
        near = torch.linspace(self.NEAR, self.T_SPLIT, self.GT_SAMPLES + 1, device=self.device)
        # uniform in disparity past T_SPLIT: the steps grow as t^2
        s = torch.linspace(1.0 / self.T_SPLIT, 1.0 / self.FAR, self.GT_FAR_SAMPLES + 1,
                           device=self.device)
        return torch.cat([near, 1.0 / s[1:]])


class ProceduralLocalDynamicSceneLoader(ProceduralDynamicSceneLoader):
    """The moving-blob scene with local, non-smooth motion: each blob
    oscillates at its own whole number of cycles (1-4) over the capture,
    and about 40% of them appear and vanish through sharp time windows
    (sigmoids of width ``APPEAR_SHARP``), drawn from ``default_rng(5555)``.
    No warp of one canonical frame represents it.  Takes the arguments of
    :class:`ProceduralDynamicSceneLoader` (``motion_amp`` 0.22 here).
    """

    APPEAR_SHARP = float(np.float32(0.02))  # ~2 frames of a 24-frame rig

    def __init__(self, *args, motion_amp: float = 0.22, **kwargs):
        rng = np.random.default_rng(5555)  # fixed across seeds
        n = kwargs.get("num_blobs", self.NUM_BLOBS)
        freq = rng.integers(1, 5, (n,)).astype(np.float32)
        gated = rng.random(n) < 0.4
        t0 = np.where(gated, rng.uniform(0.1, 0.55, n), -1.0)
        t1 = np.where(gated, t0 + rng.uniform(0.2, 0.4, n), 2.0)
        device = kwargs.get("device", "cuda")
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.motion_freq, self.appear_t0, self.appear_t1 = f32(freq), f32(t0), f32(t1)
        super().__init__(*args, motion_amp=motion_amp, **kwargs)

    def _centers_at(self, t: torch.Tensor):
        """(centres (B, 3), density gates (B,)) at time ``t``."""
        osc = torch.sin(2 * np.pi * self.motion_freq * t + self.motion_phase)[:, None]
        s = self.APPEAR_SHARP
        gate = torch.sigmoid((t - self.appear_t0) / s) * torch.sigmoid((self.appear_t1 - t) / s)
        return self.blob_centers + self.motion_amp * osc * self.motion_dirs, gate

    def _blob_weights(self, x: torch.Tensor, centers) -> torch.Tensor:
        centers, gate = centers
        d2 = ((x[:, None, :] - centers[None]) ** 2).sum(dim=-1)
        return self.blob_density * gate * torch.exp(-0.5 * d2 / self.blob_scales**2)


#: the scenes by the names the training scripts take (the JAX package's
#: eight)
PROCEDURAL_SCENES = {
    "procedural": ProceduralSceneLoader,
    "proceduralopaque": ProceduralOpaqueSceneLoader,
    "proceduraltextured": ProceduralTexturedSceneLoader,
    "proceduralthin": ProceduralThinSceneLoader,
    "proceduralmixed": ProceduralMixedSceneLoader,
    "procedural360": ProceduralUnboundedSceneLoader,
    "proceduraldynamic": ProceduralDynamicSceneLoader,
    "procedurallocaldyn": ProceduralLocalDynamicSceneLoader,
}
#: the unbounded scenes, by name: both examples train them through their
#: unbounded configurations
UNBOUNDED_SCENES = {"procedural360": ProceduralUnboundedSceneLoader}
