"""repro_torch.compress: ingestion-time dictionary compression (GraphZip).
Counterpart of `repro.compress`.

A device-resident dictionary of frequently recurring edges (members of
mined star-burst, cascade-chain and hot-edge patterns) lets the
pipeline rewrite each batch into compact pattern references plus a
residual raw-edge tail.  References commit by direct scatter to their
cached store slots, with no probing (GraphZip, Packer & Holder,
arXiv:1703.08614).

    pipe = (PipelineBuilder(cfg)
            .with_source(src)
            .with_compression()          # DictionaryStage + rewrite
            .build())

Pieces:
  * `repro_torch.kernels.pattern_mine`: the per-batch miner (kernel K5
    and its plain version),
  * `PatternDictionary` (`dictionary.py`): the signature table, ref
    counts and LRU clock, with counter-deterministic eviction,
  * `DictionaryStage` / `CompressingTransform` (`stage.py`): the
    pipeline stages producing `CompressedCommit` batches,
  * `commit_compressed` (`repro_torch.graphstore.store`): the
    pattern-aware commit.
"""
from repro_torch.compress.dictionary import (
    DICT_PROBES,
    PatternDictionary,
    dict_admit,
    dict_lookup,
    init_dictionary,
)
from repro_torch.compress.stage import (
    CompressedCommit,
    CompressingTransform,
    DictionaryStage,
)

__all__ = [
    "DICT_PROBES",
    "PatternDictionary",
    "dict_admit",
    "dict_lookup",
    "init_dictionary",
    "CompressedCommit",
    "CompressingTransform",
    "DictionaryStage",
]
