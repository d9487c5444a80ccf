"""Host utilities of the port: the weight bridge to the reference
package's parameter trees and the reference `.pth` checkpoint format."""
