"""Distribution of the port: the gradient wire codec so far."""
