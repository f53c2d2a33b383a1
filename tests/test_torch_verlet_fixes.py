"""The general path's other fix options against the JAX package's, on the
melt32 start in f64, 20 steps through ``run`` with thermo rows every 10:
fix nve/limit on group a and fix nve on group b, two Langevin fixes with
t ramps (group a with zero, group b with tally), fix momentum every 5
steps, fix viscous and energy_every 4.  Held as
``torch_parity.check_general_f64``: integer fields bit for bit, x and v
within 1e-9, f within 1e-9 x max(1, max|f|), the tally within 1e-9,
thermo values within 1e-8 x max(1, |value|)."""

from torch_parity import check_general_f64


def test_trajectory_options():
    ts = check_general_f64("mixed")
    assert float(ts.therm_e) != 0.0
