"""The plain reference of the renderer: plain torch, float32, imports
nothing of the program under test."""
