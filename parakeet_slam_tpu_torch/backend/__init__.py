from parakeet_slam_tpu_torch.backend import graph, posegraph
from parakeet_slam_tpu_torch.backend.graph import (
    PoseGraph,
    add_edge,
    add_node,
    graph_from_numpy,
    graph_to_numpy,
    make_pose_graph,
)
