"""Optimizers, schedules and clipping over the port's parameter trees."""

from .adamw import AdamWState, adamw_init, adamw_update
from .clip import clip_by_global_norm, global_norm
from .schedules import constant_schedule, cosine_schedule, wsd_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update",
           "constant_schedule", "cosine_schedule", "wsd_schedule",
           "global_norm", "clip_by_global_norm"]
