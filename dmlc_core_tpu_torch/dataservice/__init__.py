"""The 0xff9a wire (the snapshot channel's framing)."""
