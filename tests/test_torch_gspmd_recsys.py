"""The recsys global-program cells against ``repro``'s jitted cells on
4 XLA host devices: DCN-v2, SASRec and MIND (train, serve and retrieval),
on one gloo CPU rank and on 4, through the harness of
``tests/test_torch_gspmd_cells.py`` (see there); a file of their own, so
that the two halves run side by side."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_gspmd_cells as harness  # noqa: E402

CASES = {
    "dcn": ("dcn.train", "dcn.serve"),
    "sasrec": ("sasrec.train", "sasrec.serve", "sasrec.retrieval"),
    "mind": ("mind.train", "mind.serve", "mind.retrieval"),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return harness.run_reference("recsys", tmp_path_factory)


@pytest.fixture(scope="module")
def ports(reference):
    return harness.run_ports(reference, "recsys")


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_cell_matches_repros_jitted_cell(case, world, reference, ports):
    harness.check_case(reference, ports[world], CASES[case])
