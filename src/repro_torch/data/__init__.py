"""Data helpers of the LM serving stack."""
