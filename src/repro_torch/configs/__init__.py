"""Architecture configs (the published shapes) as data, with reduced
same-family SMOKE configs for CPU tests.  ``get_config(arch_id)`` returns
the full :class:`~repro_torch.models.config.ModelConfig`,
``get_smoke_config(arch_id)`` the reduced one.  Only the ``dense``
family runs in the port so far.
"""

from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    get_config,
    get_smoke_config,
)
