"""The repo's example studies (examples/) as entry points of the port: one
module per script, under the script's file name. Each module has
`build(...)`, which returns the script's model, its evaluation function
and its problem (None where the script solves no optimization), and
`main(argv=None)`, which runs the study as the script does, prints the
script's lines and returns its results as a dict. Each takes the
script's own study constants (SLSQP `maxiter`, `Nsteps`, the mesh counts
the script lets scale) with the script's values as defaults, and runs on
the CUDA card unless given a device:

    python -m femo_alpha_tpu_torch.examples.ex_gust_response_wing --device cpu
"""

EXAMPLES = (
    "ex_gust_response_wing",
    "ex_lpc_gust_like_opt",
    "ex_tiltrotor_like_opt",
    "ex_lpc_static_multicase_opt",
    "ex_gust_response_opt",
    "ex_simple_dynamic_shell_opt",
    "ex_simple_shell",
    "ex_modal_analysis",
    "ex_frequency_constrained_opt",
    "ex_aeroelastic_interface",
    "ex_pav_wing_thickness_opt",
    "ex_plate_shape_opt",
    "ex_thickness_opt_cantilever_beam",
    "ex_million_dof_shell",
)
