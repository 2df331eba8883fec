"""Architecture configs (the published shapes) as data, with reduced
same-family SMOKE configs for CPU tests.  ``get_config(arch_id)`` returns
the full :class:`~repro_torch.models.config.ModelConfig`,
``get_smoke_config(arch_id)`` the reduced one.  ``SHAPES``,
``shape_applicable`` and ``input_specs`` are the dry run's cells.
"""

from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    get_config,
    get_smoke_config,
    input_specs,
    shape_applicable,
)
