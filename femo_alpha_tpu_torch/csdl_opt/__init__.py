"""csdl_alpha_opt parity layer (port of femo_alpha_tpu/csdl_opt).

The reference adapts FEA problems into csdl graph operations. Here autograd
is the graph engine, so FEAModel.evaluate is already differentiable; these
classes expose the reference's four-method operation contract (evaluate /
solve_residual_equations / compute_jacvec_product / apply_inverse_jacobian)
for users who drive their own chain rule. They run on the device of the
FEA problem they wrap (the CUDA card unless it was built with another).
"""

from .output_operation import OutputFieldOperation, OutputOperation
from .state_operation import StateOperation

__all__ = ["StateOperation", "OutputOperation", "OutputFieldOperation"]
