"""Scene representation, colours and the scene makers (frozen copies)."""
