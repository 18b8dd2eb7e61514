"""The port's counterparts of the reference's ``analysis/`` roles. Only
the memory planner is here (``ir/capacity.py``): the reference's IR
audits read JAX programs, which the port does not have."""
