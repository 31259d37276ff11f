"""PyTorch port: the K10 ablation tool (`vap_realtime_tpu_torch.tools.
k10_ablate`).  Its variants are textual edits of `csrc/attend_pair.cu`,
built and timed on the card only; here each edit must still match the
source exactly once, and the tool must refuse to run without a card."""

import pytest
import torch

from vap_realtime_tpu_torch.tools import k10_ablate


@pytest.mark.parametrize("name", sorted(k10_ablate.VARIANTS))
def test_variant_edits_match_the_source_once(name):
    """Each variant's edits match the committed source exactly once and
    change it (the unedited "kernel" aside); against another text they
    raise rather than build a copy that is not the variant named."""
    src = open(k10_ablate.SOURCE).read()
    assert (k10_ablate.variant_source(name, src) == src) == (
        name == "kernel")
    if k10_ablate.VARIANTS[name]:
        with pytest.raises(ValueError, match="matches 0 times"):
            k10_ablate.variant_source(name, "")


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        k10_ablate.main(["--reps", "1"])
