"""Linear elasticity examples: rotated_fibers, high_res_micro."""
