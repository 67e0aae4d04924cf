"""Scene containers and two-view geometry."""
