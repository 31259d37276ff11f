"""Operations and bytes of the port's kernels and of a whole serving
tick or training step, from shapes alone (the roofline's numerators).
One module per kernel (`counts/<kernel>.py`), plus `model.py` for the
whole step."""
