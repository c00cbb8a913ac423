"""Performance modelling: the collective cost model, the shared prediction
path, feature specs, the LeNet-5 measured sweep, and a traced step's costs
(``op_analysis``) and roofline terms (``roofline``)."""
