"""The transient shell's operation layer: StateOperation,
TotalStrainEnergyOperation and VolumeOperation as plain differentiable
functions.

Port of femo_alpha_tpu/models/dynamic_rm_shell/operations.py. `evaluate`
calls PlateSim.simulate, and backward() of any scalar downstream is the
time-reversed adjoint sweep. gradient_mode is accepted for signature parity
and ignored.
"""

from __future__ import annotations

from ...assembly.assemble import FemForm, assemble_scalar


class StateOperation:
    """state = the full displacement history, shape
    (time_levels * fe_dofs,), time-major."""

    def __init__(self, plate_sim, gradient_mode="torch", record=False,
                 path=None):
        self.plate_sim = plate_sim
        self.gradient_mode = gradient_mode
        self.record = record
        self.path = path

    def evaluate(self, thickness, f_history=None):
        sim = self.plate_sim
        fh = sim.f_history if f_history is None else f_history
        return sim.simulate(thickness, fh).reshape(-1)


class TotalStrainEnergyOperation:
    """sum_t strain_energy(w_t), plus the thickness regularization of
    `regularization` ("L2") scaled by the step count."""

    def __init__(self, plate_sim, regularization=None, alpha=1e-2):
        self.plate_sim = plate_sim
        self.regularization = regularization
        self.alpha = alpha

    def evaluate(self, disp_history, thickness):
        sim = self.plate_sim
        wh = disp_history.reshape(sim.time_levels, sim.fe_dofs)
        t = sim._tensor(thickness)
        total = sim.strain_energy_history(wh, t).sum()
        if self.regularization is not None:
            kern = sim.pde.regularization_kernel(self.regularization)
            form = FemForm(sim.pde.VT, lambda u, x, p: kern(
                None, x, {"thickness": p["thickness"]}),
                kind="energy", param_specs={"thickness": sim.pde.VT})
            total = total + sim.Nsteps * assemble_scalar(
                form, t, {"thickness": t})
        return total


class VolumeOperation:
    """V = int t dx; its gradient by backward()."""

    def __init__(self, plate_sim):
        self.plate_sim = plate_sim

    def evaluate(self, thickness):
        return self.plate_sim.volume(thickness)
