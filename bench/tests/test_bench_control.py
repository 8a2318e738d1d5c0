"""The controls of the serving cells' checks, on the card at a size a test
run can hold (published widths, fewer layers, fewer slots, a short
window): the reference computed in float8 in the program's place must read
far past what the program reads. ``bench/tools/control.py`` reads the same
at the cells' own sizes."""

import copy

import pytest

import harness
from tools import control

pytestmark = pytest.mark.gpu


def _small(name: str) -> harness.Cell:
    c = copy.deepcopy(harness.load_cell(name))
    c.config["model"]["n_layers"] = 4
    mix = c.mix
    if mix["driver"] == "serve_open":
        mix["engine"].update(slots=8, max_seq=1024)
        mix["trace"].update(req_rate=1.0, prompt_median=256, max_prompt=768,
                            output_median=32, max_output=96)
        mix.update(history_s=30, max_parked=16, drain_s=20)
    elif mix["driver"] == "serve_closed":
        mix["engine"].update(slots=8, max_seq=1024)
        mix["trace"].update(prompt_median=512, max_prompt=800)
    return c


SERVE = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]
    if harness.load_cell(w["name"]).driver.startswith("serve")]


@pytest.mark.parametrize("name", SERVE)
def test_served_control_reads_past_the_program(name, cuda):
    rows = control.control_runs(_small(name), [2**31 + 91, 2**31 + 92],
                                5.0, cuda)
    for r in rows:
        assert r["tokens"] > 0
        assert r["control_gap"] >= 3 * r["program_gap"], r
