"""Graph algorithms (`graph.py`) and robust linear solvers (`l1.py`)."""
