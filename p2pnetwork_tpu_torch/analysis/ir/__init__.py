"""The memory planner (``capacity.py``) and its coefficients fitted on
the card (``membudgets.json``)."""
