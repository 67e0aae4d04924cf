"""Camera model types (the camera models port with the intrinsics slice)."""
