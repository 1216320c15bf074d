"""The micro cell-problem engine and its fused chunk-PCG kernel."""
