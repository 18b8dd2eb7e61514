"""Host-side helpers of the port (its own copies of what it needs from the
reference's ``utils/``)."""
