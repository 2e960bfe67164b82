"""Plain references in torch and numpy; nothing here imports the program under test."""
