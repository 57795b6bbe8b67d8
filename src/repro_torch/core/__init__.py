"""Model, planner and execution plan of the port."""
