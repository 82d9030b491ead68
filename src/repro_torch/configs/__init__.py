"""Configurations: the ingestion deployment (`paper_ingest`, a copy of the
reference's) and the served LM architectures.  Importing this package
registers every ported architecture."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    register,
    smoke_config,
)

# one module per ported architecture (registration side effect)
from repro_torch.configs import mamba2_780m, paper_ingest, qwen2_5_3b  # noqa: F401,E402
