"""Plain references and frozen copies: nothing here imports the program."""
