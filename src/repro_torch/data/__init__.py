"""Synthetic packed LM batches for training (numpy).  The directory also
holds the reference goldens (`reference_*.json` / `.npz`) that the
tests and `chip_smoke.py` read by path."""
from .pipeline import (DataConfig, StragglerSimulator, SyntheticCorpus,
                       microbatches, packed_batches)
