"""What the host side of the fused Riccati kernel's sources promises, on
the CPU (the kernels themselves build and run on the card only): the
stage-clock names the wrapper gives each source's counters, and the copy
paths ``csrc/riccati_large.cu``'s launcher reports."""

import re

import pytest

from ilqr_tpu_torch.ops import _build, cuda_riccati


@pytest.mark.parametrize("source", ["riccati", "riccati_wide",
                                    "riccati_large", "riccati_xl",
                                    "riccati_cluster"])
def test_stage_names_match_the_source(source):
    # riccati_stage_clocks names the [B, kStages] counters of a source's
    # stage-clock build by STAGES: one name a counter.
    text = (_build.CSRC / f"{source}.cu").read_text()
    (count,) = re.findall(r"constexpr int kStages = (\d+);", text)
    assert len(cuda_riccati.STAGES[source]) == int(count)
    assert len(set(cuda_riccati.STAGES[source])) == int(count)


def test_large_plan_interface():
    # The copy path riccati_large.cu's launcher reports is its layout: 1
    # (the bulk-copy engine) batch-first, 0 (a value a copy) batch-last.
    paths = cuda_riccati.COPY_PATHS
    assert paths[cuda_riccati.BATCH_FIRST] == "tma"
    assert paths[cuda_riccati.BATCH_LAST] == "per_element"
