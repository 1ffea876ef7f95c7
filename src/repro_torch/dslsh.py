"""``repro_torch.dslsh`` — the public name of the port's Deployment API
(``repro_torch.api``)::

    from repro_torch import dslsh

    cfg = dslsh.make_config(dslsh.FamilyConfig(...), dslsh.BudgetConfig(...))
    index = dslsh.build(seed, data, cfg, dslsh.grid(nu=2, p=8))
    res = index.query(queries)
"""
from repro_torch.api import *  # noqa: F401,F403
from repro_torch.api import __all__  # noqa: F401
