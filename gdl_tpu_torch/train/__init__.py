"""Steps and optimizer of the port: the DGL train and eval steps, SGD."""
