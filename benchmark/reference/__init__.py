"""The plain references of the configurations, one file each, found by the
configuration's name. They import nothing of the program."""
