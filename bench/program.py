"""The calls into the system under test (``repro_torch``) that every driver
shares: the configuration from a configuration file, and the inputs made
from the seed handed over as the program takes them."""
from __future__ import annotations

from bench import check, inputs


def slsh_config(config: dict):
    """The program's ``SLSHConfig`` from a configuration file's ``slsh``."""
    from repro_torch import dslsh

    return dslsh.make_config(**config["slsh"])


def seeded_inputs(run, queries: int, purpose: str = "queries") -> dict:
    """The data, its labels, ``queries`` held-out windows and the hash family,
    all on the run's device, from the run's seed."""
    spec = run.config["windows"]
    data, labels = inputs.windows(spec, run.config["n"], inputs.generator(run.seed, "data", run.device))
    pool, pool_labels = inputs.windows(spec, queries, inputs.generator(run.seed, purpose, run.device))
    outer, inner = inputs.family(run.config["slsh"], spec["d"], inputs.generator(run.seed, "family", run.device))
    return {"data": data, "labels": labels, "pool": pool, "pool_labels": pool_labels,
            "outer": outer, "inner": inner}


def build_grid(run, inp: dict):
    """The grid deployment of the run's configuration over the seeded data."""
    from repro_torch import dslsh

    dep = run.config["deployment"]
    return dslsh.build(run.seed, inp["data"], slsh_config(run.config), dslsh.grid(nu=dep["nu"], p=dep["p"]),
                       run.device, params=(inp["outer"], inp["inner"]))


class TablesOff:
    """The ``on_cell`` hook of the reference's grid walk: counts the entries
    of each of the grid index's cells that differ from the reference's."""

    def __init__(self, index):
        self.cells, self.p, self.total = index.pipeline_index, index.deploy.p, 0

    def __call__(self, j: int, c: int, ref_cell) -> None:
        self.total += check.cell_tables_off(self.cells[j * self.p + c], ref_cell)
