"""Point-cloud and reconstruction alignment (`alignment.py`)."""
