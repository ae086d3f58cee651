"""The calls into the program that a traffic mix's ``entry`` names."""
