from .schema import ConfigError, to_bool  # noqa: F401
from .scheduler import expand_layerwise_schedule, expand_schedule  # noqa: F401
from .model_dsl import ModelStatement, parse_model, validate_model  # noqa: F401
from .cfg import (  # noqa: F401
    ArchSpec,
    BatchesSpec,
    DatasetSpec,
    DecodingSpec,
    ExperimentConfig,
    FeatureSpec,
    ForwardSpec,
    LabelSpec,
    OptimizerSpec,
    apply_overrides,
    load_config,
    read_ini,
    resolve_n_out,
)
