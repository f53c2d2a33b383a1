"""The general path's GJF Langevin (``fix langevin gjf``, the
Gronbech-Jensen/Farago kicks of integrate/verlet.py) against the JAX
package's, on the melt32 start in f64, 20 steps through ``run`` with
thermo rows every 10: vhalf with tally, zero and a group, and vfull.

Tolerances as ``torch_parity.check_general_f64``: integer fields bit for
bit, x and v within 1e-9, f within 1e-9 x max(1, max|f|), the tally
within 1e-9, thermo values within 1e-8 x max(1, |value|).  The gaussian
draws go through ``torch.special.erfinv``, which is not XLA's ``erf_inv``
bit for bit (the draws agree to ~3e-15): the runs still meet these
tolerances."""

import pytest

from torch_parity import check_general_f64


@pytest.mark.parametrize("name", ["gjf_vhalf", "gjf_vfull"])
def test_trajectory_gjf(name):
    ts = check_general_f64(name)
    if name == "gjf_vhalf":
        assert float(ts.therm_e) != 0.0
