from .planner import (  # noqa: F401
    ChunkTask,
    EpochPlan,
    ExperimentPlan,
    build_plan,
    repair_resume_point,
    split_chunks,
    validation_points,
)
