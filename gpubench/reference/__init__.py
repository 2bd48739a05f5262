"""The plain reference: VBEM and VBHEM in plain PyTorch, importing
nothing of the program under test."""
