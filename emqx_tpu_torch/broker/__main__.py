from .listener import main

main()
