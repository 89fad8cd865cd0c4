from .recipe import RecipeConfig, RunDir, run_recipe

__all__ = ["RecipeConfig", "RunDir", "run_recipe"]
