"""`make_train_step` against `repro`'s on the CPU for the two
architectures with their own inputs: granite-moe-3b-a800m (the MoE
router's aux loss in the loss and the metrics; microbatches 2) and
whisper-large-v3 (the audio frames; microbatches 1).  The setting and tolerances are
test_torch_train.py's, whose helpers these cases share.
"""
from __future__ import annotations

import pytest

from test_torch_train import check_against_repro


@pytest.mark.parametrize("arch,microbatches", [
    ("granite-moe-3b-a800m", 2), ("whisper-large-v3", 1)])
def test_train_step_matches_repro(arch, microbatches):
    check_against_repro(arch, microbatches, 1.0)
