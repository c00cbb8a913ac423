"""The scenario planner (``repro.perf.planner``); so far the one helper the
arch sweep prices its collectives with (``space.model_comm_sizes``)."""
