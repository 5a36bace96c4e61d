"""Trainers: the occupancy-grid, proposal-network and BARF trainers."""
from .barf import BARFTrainer, BARFTrainState
from .ngp_occ import NGPOccTrainer, TrainState, make_lr_schedule
from .ngp_prop import NGPPropTrainer, PropTrainState

__all__ = [
    "BARFTrainer", "BARFTrainState", "NGPOccTrainer", "NGPPropTrainer", "PropTrainState",
    "TrainState", "make_lr_schedule",
]
