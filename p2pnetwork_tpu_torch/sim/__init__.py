"""Graph builds and the run-to-coverage engine of the port."""
