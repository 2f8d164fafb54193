"""The plain reference that decides correct: nothing here imports the program."""
