"""Performance modelling: the collective cost model, the shared prediction
path, feature specs and the LeNet-5 measured sweep."""
