"""Task families: goal-sequencing handlers that drive the MPC stack
(the reference's example-level goal publishers: figure-8 tracking,
pick-and-place waypoint sequencing)."""

from parallel_ddp_tpu_torch.tasks.pick_and_place import (
    PickAndPlaceConfig,
    PickAndPlaceGoalNode,
    make_pick_place_device_loop,
    sample_waypoints,
)

__all__ = [
    "PickAndPlaceConfig",
    "PickAndPlaceGoalNode",
    "make_pick_place_device_loop",
    "sample_waypoints",
]
