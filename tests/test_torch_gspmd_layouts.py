"""The LM cells' other layouts against ``repro``'s jitted cells on 4 XLA
host devices, through the harness of ``tests/test_torch_gspmd_cells.py``
(see there): heads that do not split over "model" (one kv head, gathered;
6 q and 3 kv heads, each rank's q heads reading parts of two kv heads; 3
q heads, 1.5 a rank, a head split across the two ranks and computed on
both), and a MoE ``train_4k`` in 8
microbatches of one row, which one of the two data ranks holds (the
capacity queue over uneven pieces); a file of its own, so that the
halves run side by side."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_gspmd_cells as harness  # noqa: E402

CASES = {
    "lm_kv_gathered": ("kvg.train", "kvg.prefill"),
    "lm_heads_replicated": ("rep.train", "rep.prefill"),
    "lm_heads_crossing": ("cross.train", "cross.prefill"),
    "lm_moe_uneven_microbatches": ("uneven.train",),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return harness.run_reference("layouts", tmp_path_factory)


@pytest.fixture(scope="module")
def ports(reference):
    return harness.run_ports(reference, "layouts")


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_cell_matches_repros_jitted_cell(case, world, reference, ports):
    harness.check_case(reference, ports[world], CASES[case])
