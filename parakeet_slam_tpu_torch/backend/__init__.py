from parakeet_slam_tpu_torch.backend import ba, graph, posegraph
from parakeet_slam_tpu_torch.backend.ba import BAResult, optimize_ba
from parakeet_slam_tpu_torch.backend.graph import (
    BAProblem,
    BAProblemBuckets,
    BAProblemPacked,
    PoseGraph,
    add_edge,
    add_node,
    ba_problem_from_numpy,
    ba_problem_to_numpy,
    graph_from_numpy,
    graph_to_numpy,
    make_ba_problem,
    make_pose_graph,
    pack_buckets,
    pack_problem,
)
