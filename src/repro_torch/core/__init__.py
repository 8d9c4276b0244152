"""DARTH core: declarative recall through early termination."""
