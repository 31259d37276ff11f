"""PyTorch port: the K7 ablation tool (`vap_realtime_tpu_torch.tools.
k7_ablate`).  Its variants are textual edits of `csrc/conv_stack_fused.cu`,
built and timed on the card only; here each edit must still match the
source exactly once, and the tool must refuse to run without a card."""

import pytest
import torch

from vap_realtime_tpu_torch.tools import k7_ablate


@pytest.mark.parametrize("name", sorted(k7_ablate.VARIANTS))
def test_variant_edits_match_the_source_once(name):
    """Each variant's edits match the committed source exactly once and
    change it (the unedited "kernel" aside); against another text they
    raise rather than build a copy that is not the variant named."""
    src = open(k7_ablate.SOURCE).read()
    assert (k7_ablate.variant_source(name, src) == src) == (name == "kernel")
    if k7_ablate.VARIANTS[name]:
        with pytest.raises(ValueError, match="matches 0 times"):
            k7_ablate.variant_source(name, "")


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        k7_ablate.main(["--reps", "1"])
