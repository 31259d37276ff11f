"""PyTorch port: the K5 ablation tool (`vap_realtime_tpu_torch.tools.
k5_ablate`) and the crossover tool (`tools.lstm_bodies`).  The ablation's
variants are textual edits of `csrc/lstm_scan.cu`, built and timed on the
card only; here each edit must still match the source exactly once, and
both tools must refuse to run without a card."""

import pytest
import torch

from vap_realtime_tpu_torch.tools import k5_ablate, lstm_bodies


@pytest.mark.parametrize("name", sorted(k5_ablate.VARIANTS))
def test_variant_edits_match_the_source_once(name):
    """Each variant's edits match the committed source exactly once and
    change it (the unedited "kernel" aside); against another text they
    raise rather than build a copy that is not the variant named."""
    src = open(k5_ablate.SOURCE).read()
    assert (k5_ablate.variant_source(name, src) == src) == (
        name == "kernel")
    if k5_ablate.VARIANTS[name]:
        with pytest.raises(ValueError, match="matches 0 times"):
            k5_ablate.variant_source(name, "")


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        k5_ablate.main(["--reps", "1"])


def test_lstm_bodies_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        lstm_bodies.main(["--batches", "16", "--steps", "5"])
