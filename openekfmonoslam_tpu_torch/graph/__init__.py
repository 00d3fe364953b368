"""Keyframe pose-graph layer with loop closure (port of graph/).  See
openekfmonoslam_tpu_torch.graph.pose_graph."""

from openekfmonoslam_tpu_torch.graph.pose_graph import (  # noqa: F401
    PoseGraph,
    add_keyframe,
    add_loop_edge,
    make_pose_graph,
    optimize,
    relative_pose,
)
