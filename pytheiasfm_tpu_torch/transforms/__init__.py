"""Point-cloud alignment (`alignment.py`)."""
