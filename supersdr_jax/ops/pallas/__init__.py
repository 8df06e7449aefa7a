"""Pallas GPU kernels (Triton route) for the stages where XLA's own code
leaves time on the table: the receiver chain's recurrent tail."""
