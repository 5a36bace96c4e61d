"""D-NeRF synthetic dataset loader (dynamic scenes with timestamps).

PyTorch counterpart of nerfacc_tpu/data/dnerf_synthetic.py: the Blender
loader's conventions and draws, plus each frame's ``time`` (``i / (n - 1)``
where the JSON has none); every item carries the per-ray ``timestamps``
(n_rays, 1), and ``timestamps`` (n_frames, 1) holds all frame times, for a
trainer's occupancy refresh.  Reading the images needs ``imageio``.
"""
from __future__ import annotations

import numpy as np
import torch

from .nerf_synthetic import SubjectLoader as _StaticLoader
from .nerf_synthetic import _load_renderings


class SubjectLoader(_StaticLoader):
    """One D-NeRF scene; the arguments of the Blender loader."""

    SUBJECT_IDS = ["bouncingballs", "hellwarrior", "hook", "jumpingjacks", "lego",
                   "mutant", "standup", "trex"]

    def __init__(self, *args, **kwargs):
        self._times = []
        super().__init__(*args, **kwargs)
        times = np.concatenate(self._times).astype(np.float32)[:, None]
        self.timestamps = torch.tensor(times, device=self.device)

    def _load_split(self, root_fp, subject_id, split):
        images, camtoworlds, focal, frames = _load_renderings(root_fp, subject_id, split)
        self._times.append(np.asarray(
            [f["time"] if "time" in f else float(i) / (len(frames) - 1)
             for i, f in enumerate(frames)], dtype=np.float32))
        return images, camtoworlds, focal

    def __getitem__(self, index: int):
        data = super().__getitem__(index)
        ids = torch.as_tensor(self._last_image_id, device=self.device)
        data["timestamps"] = self.timestamps[ids]
        return data
