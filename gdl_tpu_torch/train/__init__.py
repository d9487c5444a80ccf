"""Steps of the port. Only the DGL eval step is ported so far."""
