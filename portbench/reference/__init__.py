"""The plain reference that decides ``correct``: float32 PyTorch (TF32 off
where it runs on a card), written from the published description, importing
nothing of the program."""
