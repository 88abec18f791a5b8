"""The plain reference that decides ``correct``: plain torch and numpy,
nothing of the program."""
