"""Config, checkpoints, logging and plots (the JAX package's ``utils`` names;
``export_program`` takes ``export_stablehlo``'s place, and the JAX-only
``runtime`` has no counterpart). Importing it imports no matplotlib."""

from .config import (  # noqa: F401
    get_config_value,
    load_all_configs,
    load_config,
    merge_configs,
    print_config,
    save_config,
    set_config_value,
    validate_config,
)
from .checkpoint import (  # noqa: F401
    checkpoint_info,
    export_program,
    load_checkpoint,
    load_model_weights,
    load_program,
    save_checkpoint,
    save_model_weights,
)
from .logging import MetricsLogger, Stopwatch  # noqa: F401
